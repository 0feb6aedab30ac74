"""Chip smoke test of the PyTorch port on one CUDA card (H100).

Run from the repo root on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):
  1. card name and power limit, torch and CUDA versions;
  2. build of every kernel from nerftex_torch/kernels/csrc (one nvcc per
     source, started together);
  3. each kernel against its plain PyTorch version on the card at each
     frame's shapes and inputs (the bench frame's and the plush frame's
     texture channel, ParamNerf weights in bf16 and f32 and overlap-pick
     shapes), with times (kernel, plain, library call) and the bound.  ``ms`` is event
     time over back-to-back calls (host dispatch included); ``device_ms``
     is the same calls captured in a CUDA graph and replayed, the card's
     own time per call;
  4. the bench frame (bench.py's 512x512 carpet workload) rendered through
     the config-built port with the transplanted bench weights
     (tests/torch_bench_inputs.npz) and JAX's own draws for key(1), checked
     against tests/golden_bench_frame.npz at bench.py's 55 dB floor, with
     every kernel's launch count from that render (and which variant of
     tex_fetch and mlp_fused ran), then timed (best of 3);
  5. the f32 bench frame: the same frame with an f32 ParamNerf (the
     configs' default dtype), every mlp_fused launch on the wgmma_tf32x3
     variant (asserted), held within F32_FRAME_MAX_DIFF of the same render
     with mlp_fused routed to its plain version (mlp_wrap); golden PSNR
     for information (the golden holds a bf16 MLP); timed (best of 3); the
     frame's MLP launches, as captured, replayed from one CUDA graph beside
     the cuBLAS f32 chain on the same inputs, with the summed bound;
  6. the plush frame (configs/config_plush_render.py at 800x800 with the
     plush operating point: shadow rays, nearest_blend picks through the
     selk_resolve kernel) rendered through the config-built port with the
     transplanted plush weights (tests/torch_plush_inputs.npz) and JAX's
     own random draws for key(1) (nerftex_torch.utils.jax_rng), checked
     against tests/golden_scene_plush.npz at scripts/bench_scene.py's
     50 dB floor on the same 10x box downsample, with every kernel's launch
     count and variant from that render, then timed (best of 2);
  7. the grass frame (configs/config_grass_render.py at 512x512 with the
     port's grass operating point: a point light, shadow rays, nearest
     picks, no texture channel) rendered through the config-built port with
     the transplanted grass weights (tests/torch_grass_inputs.npz) and
     JAX's draws for key(1), checked against tests/golden_scene_grass.npz
     at the 50 dB floor on the 8x box downsample, with every kernel's
     launch count (tex_fetch must stay at 0), then timed (best of 2); then
     mlp_fused on the frame's first net_chunk of samples and selk_resolve
     on every launch of the frame, as captured, each against its plain
     version;
  8. serving: RenderSession(config_grass_render, operating_point="grass")
     on the card, restored from a checkpoint of the grass weights in the
     JAX package's pickle layout, answers four requests (the golden's pose
     and parameters, two other poses, the light moved); the first response
     must equal a direct render of its rays under
     rng.stream_key(STREAM_PERTURB, 0); latency per request and rays/s;
     then the first request's rays through a session with bf16 dots under
     key(1), its golden PSNR beside the grass frame's;
  9. the carpet and carpet10k frames (configs/config_carpet_render.py and
     configs/config_carpet10k_render.py, 900 and 10,000 patches on the
     cloth mesh, at 512x512 with the carpet operating point and their
     goldens' flags, the golden's bf16 dots, the bench weights, which both
     configs initialise), each on its config dataset's first item as the
     port's data layer builds it and JAX's draws for key(1), checked
     against tests/golden_scene_<scene>.npz at the 50 dB floor on the 8x
     box downsample, its dropped hits and samples equal to CARPET_DROPS,
     timed (best of 2) with its peak device memory; every
     kernel against its plain version at the frame's inputs (tex_fetch's
     first launch, mlp_fused's first net_chunk, every selk_resolve launch);
  10. the render mode: nerftex_torch.main on
     configs/config_grass_filtered_render.py at its own settings (512x512,
     f32, render_chunk 16384, blur_idx 0, five frames) with target_path a
     temporary directory holding a JAX-layout checkpoint of the
     grass_filtered weights (tests/torch_grass_filtered_inputs.npz): the
     five PNGs written, every mlp_fused launch wgmma_tf32x3 and no
     tex_fetch, the first PNG within one u8 level of a direct render of the
     dataset's first item under rng.stream_key(STREAM_PERTURB, 0), that
     render within 1e-3 of the same render through the plain MLP, and the
     kernels against their plain versions on that render's inputs
     (mlp_fused at the pos 81 / dir 54 maps);
  11. training: configs/config_carpet_train.py's model, renderer, loss
     and Adam at full width (the JAX init of tests/torch_train_inputs.npz,
     IEEE f32 matmuls) over the fixture's three JAX batches and keys, step
     0's loss and gradient (against JAX's, and against JAX's with float64
     dots) and the losses of steps 1 and 2 against JAX's;
     then nerftex_torch.main on a config module that deep-copies the
     shipped carpet train config with a synthetic TFRecord
     (nerftex_torch.tools.synth, 32 x 64x64, seed 0), TRAIN_STEPS steps,
     a checkpoint every TRAIN_CHECKPOINT_EVERY and the validation renders
     at the last step: 30 scalars whose last five average under 0.9x the
     first five, the three checkpoints, two validation PNGs, every
     mlp_fused launch wgmma_tf32x3, the last checkpoint restored bit for
     bit, the first PNG re-rendered from it within one u8 level and within
     1e-3 of the plain MLP's render; steps/s (validation renders and saves
     excluded), peak device memory and the validation renders' summed
     mlp_fused device time; then config_grass_filtered_train.py
     (raw_noise_std 0.1, blur_idx 0) for GRASS_FILTERED_TRAIN_STEPS steps
     on its own synthetic TFRecord: finite losses, and its validation
     render checked as the carpet one (restore, PNG, every launch
     wgmma_tf32x3, within 1e-3 of the plain MLP, the kernel against its
     plain version at the render's pos 81 / dir 54 maps: its own row);
  12. device-resident training: configs/full_carpet_train_device.py
     (device_resident, steps_per_dispatch 100, bf16, save_encodings,
     net_chunk 16384) through nerftex_torch.main on a TFRecord of
     DEVICE_TRAIN_RECORDS records cycling DEVICE_TRAIN_VIEWS synthetic
     512x512 views (rendered in parallel processes): first the sampler on
     the card against the CPU (16 records, the same keys: img_idx and loc
     equal, the batch within SAMPLER_TOLS) and DEVICE_TRAIN_GRAPH_STEPS
     graph-replayed steps against as many eager steps from the same state;
     then DEVICE_TRAIN_STEPS steps (a checkpoint every
     DEVICE_TRAIN_CHECKPOINT_EVERY, validation at the last): every step a
     replay of one captured graph and none eager (render/train.py
     step_counts), the loss falling, the checkpoints and two PNGs, the
     bf16 validation render through wgmma_bf16 alone within
     DEVICE_TRAIN_PLAIN_MAX_DIFF of the plain MLP's and the first PNG
     within one u8 level of the restored model's render (its own row);
     steps/s, seconds per dispatch and peak memory, and the host-fed step
     of the same config beside it, interleaved P C C P;
  13. the mip paths: configs/demo_grass_mip_train.py's and
     demo_grass_mip_imp_train.py's full-width steps (the port's init
     checked against the JAX factory's by per-leaf digest) over the three
     JAX batches of tests/torch_grass_mip_inputs.npz, at the training
     phase's limits; then the user's sequence through nerftex_torch.main:
     demo_grass_mip_train for MIP_TRAIN_STEPS steps on a synthetic
     TFRecord with the dataset's five parameters (the loss falling under
     0.9x, the checkpoints, two PNGs, the validation render through the
     kernel at the pos 69 / dir 54 maps within 1e-3 of the plain MLP's),
     demo_grass_mip_imp_train for MIP_IMP_TRAIN_STEPS steps (finite
     losses, the coarse terms in the loss), and demo_grass_mip_render
     from the directory the first one trained into, checked as the render
     mode (five 256x256 PNGs, the first against the direct render, the
     direct render against the plain MLP, every mlp_fused launch
     wgmma_tf32x3 at the pos 69 / dir 54 maps, no tex_fetch, selk_resolve
     against its plain version on every launch, each frame dropping the
     hits and samples the JAX package drops for it: the config's caps do
     not cover its sweep in either package), the direct render's MLP
     launches replayed beside the cuBLAS f32 chain; and 64x64 renders of
     the render config's first camera (4.2 % of it drawn) and of its pose
     at radius 2.5 (frame2, at least MIP_FRAME2_DRAWN drawn) with the JAX
     init against the JAX package's renders in the fixture, at
     MIP_GOLDEN_PSNR_DB;
  14. the compact path (sample_budget_per_ray): the bench frame at bench.py's
     settings (bf16, bf16 dots, key(1)) first on the sorted grid, whose
     per-ray n_steps give the covering budget (the smallest multiple of 8
     at which no ray block overflows), then compact at that budget (within
     COMPACT_MAX_DIFF of the grid frame, 55 dB against the golden, the grid
     frame's drops, each block taking all its samples) and at
     COMPACT_DROP_BUDGET (the drops and per-block taken counts reckoned
     from the grid frame's n_steps), both frames timed interleaved (G C C G
     G C); the f32 rays of tests/torch_compact_inputs.npz (two bench blocks
     at the dropping budget, written on the CPU by
     scripts/make_torch_compact_inputs.py from the JAX package's compact
     render) within COMPACT_F32_MAX_DIFF of JAX's and with its drops, every
     mlp_fused launch wgmma_tf32x3; and the first camera of
     configs/demo_grass_mip_render.py (the fixture's JAX init) through
     MipInstanceRenderer at its covering budget, within COMPACT_MAX_DIFF of
     its grid frame, no tex_fetch.  Every selk_resolve launch of the three
     compact frames is held against its plain version as it runs;
     mlp_fused is held against plain on the frame's net_chunk with the
     most taken samples (it must hold taken samples only) and tex_fetch on
     the first launch of the ray block that took the most; each frame has
     its kernels-line rows (bench_compact, bench_compact_f32,
     grass_mip_compact) and the phase prints its peak device memory;
  15. parallelism (nerftex_torch.parallel), in processes this script
     spawns (``--parallel-worker``), each killed after PARALLEL_TIMEOUT_S;
     a rank that does not exit 0 fails the phase.  Two gloo ranks on
     cuda:0 (NCCL refuses two ranks on one card): (a) the training phase's
     full-width step of config_carpet_train through
     make_parallel_train_step, 128 of each image's 256 rays a rank, over
     the fixture's three JAX batches, at the training phase's limits
     (loss, all-reduced step-0 gradient, later losses), both ranks'
     parameters bit-equal after every step, and rank 0's largest
     difference from the single-process port step printed; (b) the carpet
     frame at config_carpet_render's own render_chunk (16 chunks, 8 a
     rank) through shard_render, within PARALLEL_FRAME_MAX_DIFF of the
     unsharded render with its drops, each rank launching all three
     kernels and their summed launches the unsharded render's, rank 0's
     kernels against their plain versions (the kernels-line rows
     carpet_sharded), the golden PSNR printed only (the draws are chunked
     differently from the golden's).  Then an NCCL world of one: (c)
     full_carpet_train_device through make_parallel_fused_train_step on
     phase 12's 16-record table, one capture and PARALLEL_FUSED_STEPS
     replays with the all-reduce inside the graph and no eager step, the
     losses and parameters bit-equal to a single-process FusedStep's,
     steps/s of both interleaved P C C P; and the carpet frame through
     shard_render on the device all-gather, within
     PARALLEL_FRAME_MAX_DIFF of the unsharded frame;
  16. tensor parallelism and the offline tools: (a) two gloo ranks on
     cuda:0 as the (1, 2) mesh (TP_SHAPE) take the training phase's
     full-width carpet step through make_parallel_train_step with
     shard_model (each rank holding its blocks of the trunk), the loss and
     the gathered step-0 gradient against JAX's at the training phase's
     limits, the gathered parameters after three steps within
     TP_PARAM_TOL of the single-process port step's, steps/s of both
     interleaved P C C P, and a validation frame of the gathered model
     through the kernel (its carpet_tp row); (b) the grass_filtered model
     refused at tp 2 with ValueError, the carpet model placed at tp 2 and
     4; (c) make_synthetic_tfrecord(backend="torch") writes the
     full-scale carpet dataset's first shard (100 views at 512^2) with the
     march on the card, render and PNG-encode times a view, its first
     SYNTH_CHECK_VIEWS views within SYNTH_MAX_U8 levels of the numpy
     integrator (worker processes); (d) gen_assets writes meshes/* byte
     for byte, the 10,000 scale anchors included (a worker process);
  17. the device instancer against the host oracle
     (nerftex_torch/instancing/oracle.py, numpy on the host, no JAX): the
     bench, plush and grass scenes at their shipped settings (mesh,
     instances, patch box, max_hits, step and cap, light, textures, culls;
     f32 slab dots, deterministic offsets so that the oracle samples the
     same arc positions), each on ORACLE_RAYS rays of its frame (hit rays
     spread over every stride-th ray the oracle sees hit; bench adds
     missing rays), through DeviceInstancer.get_model_input on the card:
     hit, per-ray sample counts (knife-edge arcs counted), dists, the t
     spacing, alpha_last and color_last against oracle.get_model_input;
     nearest picks against the oracle's at the same arc positions up to
     anchor ties and interval-boundary knife edges, random and
     nearest_blend picks among the oracle's active instances with the
     weight of _select_instance's rule (blend weights within the range the
     pick formula's float32 error allows; counted); local points and
     directions against the oracle's transforms; bench under all three
     methods, plush under all three (its own nearest_blend first), grass
     under nearest; the texture slot of ORACLE_TEX_SAMPLES samples under
     texture_lookup="closest" against Scene.get_parameters (candidate
     misses held to the closest point over the instance's candidates) and
     under "jacobian" at tests/test_device_instancer.py's limits; grass's
     point-light strength; plush's and grass's occlusion at the device's
     own shadow points against oracle.is_shadowed (differing points must
     be knife edges); the auxiliary-mesh scene of
     tests/test_device_instancer.py; selk_resolve launched in every scene
     and tex_fetch where a parameter texture exists.  An ``oracle <scene>``
     line per scene; the phase's seconds beside ORACLE_BUDGET_S.
  18. the shadow query kernel (kernels/shadow_query.py) against its plain
     chain, bit for bit, on a full ray block of the grass and of the plush
     frame (the first block from the middle whose candidates fit the
     shadow budgets), over those candidates and over every column; a
     ``shadow_query <scene> <branch>`` line each with the kernel's device
     ms (calls replayed from a CUDA graph), the plain chain's ms and the
     bound (the float operations of the kernel's own walk, each test to its
     exit and each point to its first blocking column, over the unfused f32
     rate, against its bytes over HBM's; the kernel must not beat it).  The
     rows go into the kernels line under the grass and plush frames, beside
     those frames' shadow_query launches; every other frame must launch it
     0 times.
  19. the per-ray kernels (kernels/per_ray.py) against their plain chain
     on every ray block of the carpet, grass and plush frames, with the
     operating point's culls and with none: discrete outputs equal but on
     rays whose float64 recompute moves under a tiny perturbation (knife
     edges, listed), float tables within PER_RAY_FLOAT_TOL of their
     scale, the drop counts equal; every fitting keep set ascending and
     holding every column some ray of the block hits, at the block's own
     slab operand rounding (per_ray_hit_columns); a ``per_ray <scene>`` line
     each with a culled and a full block timed (the kernels' device ms from
     a CUDA graph, the plain chain's and DeviceInstancer._per_ray's ms,
     _per_ray's host issue ms, the bound: the float operations of the
     kernels' own walk over the unfused f32 rate against the bytes it moves
     over HBM's) and the tracer's per_ray.rays, per_ray.kernel and cull
     counts over a frame of _per_ray calls.  The rows go into the kernels
     line under the carpet, grass and plush frames, beside those frames'
     per_ray launches; every frame that runs the device instancer must
     launch it, and every training frame 0 times.
The first render of each frame runs with its selk_resolve calls captured
(selk_capture); the frame's launch histogram (launches by Rb, S, K and
method, with the window and valid slots of their inputs) is printed on a
line of its own, and it and the frame's summed bound go into the frame's
selk_resolve row (the grass, carpet, carpet10k and grass_filtered rows
time all the frame's launches together).
The last three lines of stdout are the card, the kernels JSON (one row per
kernel and frame, the f32 MLP in its own frame, bench_f32, grass_filtered's
launches those of nerftex_torch.main's five frames, carpet_train's and
grass_filtered_train's and grass_mip_train's those of their runs of
nerftex_torch.main, all in the validation renders, grass_mip's those of
nerftex_torch.main's five mip frames, carpet_sharded's those of both gloo
ranks' shard_render, carpet_tp's those of the tensor-parallel model's
validation frame, and the kernels a path did not launch) and the device
JSON.
"""

import contextlib
import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_PSNR_DB = 55.0                 # bench.py's floor
PLUSH_GOLDEN_PSNR_DB = 50.0           # scripts/bench_scene.py's floor
GRASS_GOLDEN_PSNR_DB = 50.0           # the same
CARPET_GOLDEN_PSNR_DB = 50.0          # the same, carpet and carpet10k
# The carpet frames' dropped (hits, samples), the port's on the CPU and on
# the card.  The JAX package drops 576,101 carpet samples on the CPU and
# 576,099 on the TPU: ray 141,186 (pixel 275, 386) needs 0.674 of arc, 337
# steps of 0.002 exactly, and the last ulp of its float32 arc length (JAX on
# the CPU 0.6740003, the port 0.6739998) decides 337 or 336 steps, so 17 or
# 16 dropped past the cap of 320; five more rays sit on such edges below the
# cap.  A knife edge, not a fault (ROADMAP Queue 3).
CARPET_DROPS = {"carpet": (63884, 576100), "carpet10k": (103734, 0)}
MAIN_U8_MAX_DIFF = 1                  # nerftex_torch.main's first PNG vs the direct render, u8 levels
MAIN_PLAIN_MAX_DIFF = 1e-3            # grass_filtered, kernel vs plain MLP (as the f32 bench frame)
MAIN_FRAMES = 5                       # configs/config_grass_filtered_render.py's dataset_size
SERVE_MAX_DIFF = 1e-6                 # a request vs the direct render of its rays and key
# Serving requests at the grass operating point: the golden's pose and
# parameters, two other poses, and the light moved to the other side.
GRASS_POSE = [0.30614675, -0.73910363, 0.6]
SERVE_REQUESTS = ((GRASS_POSE, None), ([0.0, -0.7, 0.7], None), ([0.6, -0.45, 0.66], None),
                  (GRASS_POSE, [0.0, 0.33, -0.8, 0.0, 0.6]))
TEX_SAMPLES = (1 << 20, 1024 * 320)   # 1M uv samples; one bench ray block (1024 x 320)
MLP_SAMPLES = {"bench": (262144,      # one render chunk's worth of samples
                         32768),      # the bench renderer's net_chunk (one launch)
               "plush": (65536,),     # the plush renderer's net_chunk
               "grass": (32768,)}     # the grass renderer's net_chunk
# Variants the frames must run (byte-valued textures; bf16 weights, f32 in
# the f32 bench frame).
FRAME_VARIANTS = {"tex_fetch": "byte_quad", "mlp_fused": "wgmma_bf16"}
F32_FRAME_VARIANTS = {"tex_fetch": "byte_quad", "mlp_fused": "wgmma_tf32x3"}
F32_FRAME_MAX_DIFF = 1e-3             # f32 bench frame, kernel vs plain MLP, color and alpha
# Tolerances, kernel vs plain version on the same card:
#  tex_fetch: both variants round every lerp operation separately (no fma)
#    and give the byte texels b / 255 correctly rounded, so they agree to
#    the bit with sample_channel_plain.
#  mlp_fused f32: FMA accumulation vs cuBLAS f32 (TF32 off) over K <= 337,
#    relative error ~K * 2^-24 per layer through 13 layers.
#  mlp_fused bf16: every layer's output is rounded to bf16 (2^-8 relative);
#    a different summation order flips single roundings, which propagate.
MLP_F32_TOL = 1e-4                    # x max(1, max|plain|)
MLP_BF16_TOL = 5e-2                   # x max(1, max|plain|)
#  selk_resolve: nearest and random picks and n_active exact (the same
#    comparisons in the same order); nearest_blend sums its weights and
#    cumsum in slot order, the plain version in PyTorch's reduction order,
#    so a pick may differ where u sits within 1e-5 of a cum value (the JAX
#    package's pin, tests/test_selk_kernel.py) and p_sel by the sums'
#    rounding where the picks agree.
SELK_SHAPE = {"bench": (1024, 320, 48),      # ray block, step cap, max_hits
              "plush": (2048, 1280, 128)}
SELK_METHODS = {"bench": ("nearest",), "plush": ("random", "nearest", "nearest_blend")}
# Render-layout inputs at each frame's hit tiers (device.py: K // 4 and
# min(K, 8) below the plush frame's max_hits of 128; bench has one tier).
SELK_RENDER_SHAPES = {"bench": ((1024, 320, 48),),
                      "plush": ((2048, 1280, 8), (2048, 1280, 32), (2048, 1280, 128))}
SELK_BLEND = 0.2 * 0.04               # plush: 0.2 x patch_scale
SELK_EDGE = 1e-5
SELK_P_RTOL = 1e-4
SELK_OPS_PER_SLOT = 15                # per (sample, slot of its stabbing window)
SELK_OPS_PER_STEP = 4                 # per binary-search step: midpoint, load, compare, select

# The training phase (configs/config_carpet_train.py and
# configs/config_grass_filtered_train.py through nerftex_torch.main).
TRAIN_STEP_LOSS_RTOL = 1e-5           # step 0's loss vs tests/torch_train_inputs.npz (JAX)
# Step 0's gradient, x the leaf's max |g|, against JAX's and against JAX's
# with float64 dots (both in tests/torch_train_inputs.npz).  Each leaf is
# a sum over 262,144 samples through up to 8 layers.  Float64 dots move
# JAX's own gradient by at most 5.2e-5 (trunk/0/w; the fixture script
# prints each leaf), yet the port reads about as far from the float64-dot
# gradient as from JAX's f32 one (2.9e-4 on trunk/1/w): the spread is in
# the float32 work before the dots (sample positions and encodings, which
# XLA fuses and rounds in other orders), not in the sums, and 1e-4 would
# hold the port to less than that.  Past the first two trunk layers every
# leaf reads under 7.5e-5 from the float64-dot gradient.
TRAIN_GRAD_TOL = 5e-4
TRAIN_LATER_LOSS_RTOL = 1e-4          # steps 1 and 2, after Adam updates
TRAIN_STEPS = 300                     # the user's command: n_iters, i_img
TRAIN_CHECKPOINT_EVERY = 100
TRAIN_PLAIN_MAX_DIFF = 1e-3           # a validation render, kernel vs plain MLP
TRAIN_SYNTH = dict(n_images=32, size=64, seed=0)
GRASS_FILTERED_TRAIN_STEPS = 20
# The device-resident training phase (configs/full_carpet_train_device.py
# through nerftex_torch.main): a TFRecord of DEVICE_TRAIN_RECORDS records
# cycling DEVICE_TRAIN_VIEWS distinct synthetic 512x512 views (the config's
# dataset scale: a 5.24 GB u8 table on the card).
DEVICE_TRAIN_VIEWS = 4
DEVICE_TRAIN_RECORDS = 5000
DEVICE_TRAIN_STEPS = 600              # n_iters and i_img: 6 dispatches of 100
DEVICE_TRAIN_CHECKPOINT_EVERY = 300
DEVICE_TRAIN_RATE_STEPS = (100, 500)  # steps/s between these logger calls
DEVICE_TRAIN_CHECK_VIEWS = 16         # the sampler and graph checks' dataset
DEVICE_TRAIN_GRAPH_STEPS = 5
# The interleaved P C C P comparison: P host-fed steps (its host pipeline
# decodes every 512x512 PNG it samples: ~5 steps/s), C device-resident
# steps (one dispatch of 100).
HOST_FED_COMPARE_STEPS = 30
DEVICE_COMPARE_STEPS = 100
# The sampler on the card vs on the CPU (tests/test_device_dataset.py's
# tolerances): rays, t, cone_scale, and the u8 decode, which the card
# computes as a reciprocal multiply (the CPU divides).
SAMPLER_TOLS = {"rays_o": 1e-6, "rays_d": 1e-6, "t": 1e-5, "cone_scale": 1e-7, "color": 4e-7,
                "alpha": 4e-7, "parameters": 0}
# Graph replays vs eager steps on the card, from the same state: the
# backward's index_add (repeat_interleave's gradient) sums with atomics in
# an order that changes from run to run, so the two may round apart; an
# Adam update moves an element by about lrate at most, so after K steps two
# runs part by at most 2 K lrate (5e-3 at the config's 5e-4) where a
# near-zero gradient's sign differs, and their losses by the rounding.
GRAPH_LOSS_RTOL = 1e-4
GRAPH_PARAM_TOL = 2 * DEVICE_TRAIN_GRAPH_STEPS * 5e-4
# The bf16 validation render through the kernel vs through the plain MLP
# (mlp_fused_plain): both round every layer's output to bf16 (2^-8
# relative) at other places, so colors and alphas part by a few bf16 ulps
# of the [0, 1] outputs; the per-launch check's 0.05 of the output scale.
DEVICE_TRAIN_PLAIN_MAX_DIFF = 0.05
# The mip phase (configs/demo_grass_mip_train.py, demo_grass_mip_imp_train.py
# and demo_grass_mip_render.py through nerftex_torch.main): the full-width
# steps against tests/torch_grass_mip_inputs.npz at the training phase's
# limits, then the user's train-then-render sequence.
MIP_INPUTS = "torch_grass_mip_inputs.npz"
MIP_TRAIN_STEPS = 300                 # n_iters and i_img of the user's train command
MIP_TRAIN_CHECKPOINT_EVERY = 100
MIP_IMP_TRAIN_STEPS = 20
MIP_SYNTH_PARAMETERS = (2, 3)         # the dataset's [Blur, Length, LightXYZ]
MIP_MAPS = (69, 54)                   # pos: IPE 60 + Length 9; dir: 27 + LightXYZ 27
MIP_GOLDEN_PSNR_DB = 50.0             # the 64x64 full-width frames vs the JAX package's
MIP_FRAME2_DRAWN = 0.5                # the second camera's share of drawn rays
COMPACT_MAX_DIFF = 1e-5               # compact frame vs its grid frame, color and alpha
COMPACT_DROP_BUDGET = 32              # the dropping budget per ray
COMPACT_INPUTS = "torch_compact_inputs.npz"
COMPACT_F32_MAX_DIFF = 1e-3           # the f32 fixture rays vs the JAX package's render
COMPACT_SELK_TIMED = 8                # selk_resolve launches kept per frame for timing
PARALLEL_TIMEOUT_S = 300              # each spawned job of phase 15
PARALLEL_FRAME_MAX_DIFF = 1e-6        # the gathered carpet frame vs the unsharded render
PARALLEL_FUSED_STEPS = 20             # replays of the captured data-parallel step
PARALLEL_RATE_STEPS = 100             # steps a side in the P C C P timing
# Phase 16: tensor parallelism and the offline tools.
TP_SHAPE = (1, 2)                     # (dp, tp): two gloo ranks on the card
TP_PARAM_TOL = 1e-4                   # vs the single-process step after three steps
# A frame of the trained model: config_carpet_train's second validation
# parameters, seen from tests/test_toolchain.py's synth pose.
TP_VALIDATION = dict(size=64, eye=(2.0, -2.5, 2.2), angle=0.63,
                     parameters=[1, 1, 1, 0.1, 0, -0.707, 0.707])
SYNTH_SHARD = dict(n_images=100, size=512, n_parameters=(1, 6), seed=0, imgs_per_shard=100)
SYNTH_CHECK_VIEWS = 4                 # held to the numpy integrator
SYNTH_MAX_U8 = 2                      # tests/test_toolchain.py:262
SYNTH_MAX_SHARE = 0.2                 # :263
SCALE_ANCHORS = 10000                 # meshes/cloth10k_anchor_points.ply
# Phase 17: the device instancer against the host oracle.
ORACLE_RAYS = {"bench": (256, 32), "plush": (64, 0), "grass": (64, 0)}  # hit, missing rays
ORACLE_SCAN = 3                       # rays scanned at a fixed stride per ray kept
ORACLE_KEY = 0                        # the device's pick draws and the oracle's seed
ORACLE_TEX_SAMPLES = 2048             # texture slots held at a fixed stride of samples
ORACLE_EDGE = 1e-5                    # knife edges: arcs, anchor ties, boundaries, shadow slack
ORACLE_PICK_ULPS = 8                  # float32 error of the device's anchor d^2, in ulps of its terms
ORACLE_TOLS = {"dists": 1e-4, "t_spacing": 2e-3, "alpha_last": 1e-5, "color_last": 2e-2,
               "pts": 1e-4, "rays_d": 1e-4, "alpha_weight": 1e-4, "texture": 1e-4,
               "point_light": 1e-4}  # alpha_weight and point_light relative
ORACLE_BLEND_BIAS = 1e-3              # mean relative blend weight error (measured 3.8e-5)
ORACLE_JACOBIAN = (0.06, 0.25)        # tests/test_device_instancer.py:303-304, mean and max
# The max is that test's limit on the smooth checkerboard; plush's
# checkerboard.png has hard edges, where a fraction of a texel of uv flips a
# sample's value by up to 0.5, so plush holds the mean and prints the max.
ORACLE_JACOBIAN_MAX_SCENES = ("bench",)
ORACLE_AUX_SHADED = 0.05              # :382, the aux terminator is shaded
ORACLE_BUDGET_S = 60
H100_BYTES_PER_S = 3.35e12            # HBM3, SXM data sheet
H100_BF16_FLOPS = 989e12              # dense tensor-core bf16
H100_F32_FLOPS = 67e12                # f32 outside the tensor cores
H100_TF32_FLOPS = 495e12              # dense tensor-core TF32
TF32X3_PRODUCTS = 3                   # wgmma_tf32x3: a_lo w_hi + a_hi w_lo + a_hi w_hi
H100_F32_OPS = H100_F32_FLOPS / 2     # unfused f32 operations a second (an fma counts two)
# Float operations (multiplies, adds, subtracts, the division, the
# reciprocal; comparisons uncounted) of csrc/shadow_query.cu's tests up to
# each exit.  A box: d_z (5); o_z and the two faces' numerators (8); o_x,
# o_y, d_x, d_y (22); per face tried, its division (1) and, with t in
# range, the crossing (4).  A triangle: the front-face test (5); the
# P vector and det (14); 1 / det, the T vector and u (10); Q and v (15);
# u + v (1); t (6).
SHADOW_BOX_STEPS = (5, 8, 22)
SHADOW_FACE_OPS = (1, 4)
SHADOW_TRI_STEPS = (5, 14, 10, 15, 1, 6)
SHADOW_TIMED_CALLS = 20               # kernel calls a CUDA graph holds
PER_RAY_FLOAT_TOL = 1e-6              # kernel vs plain chain, x each float table's largest |value|
# A ray whose discrete outputs differ between the kernels and the plain chain
# must sit on a knife edge: its float64 recompute's discrete outputs change
# when its origin or direction moves by PER_RAY_EDGE_RAY (x max(|o|, 1); a
# dozen float32 ulps of the world coordinates) or every box's translation by
# PER_RAY_EDGE_BOX (x (1 + |T|); the local frames are ~11-25x the world's,
# and with bf16 dots only the translation enters the slab test unrounded).
PER_RAY_EDGE_RAY = 1e-6
PER_RAY_EDGE_BOX = 2e-6
# Float operations of csrc/per_ray.cu's walk (multiplies, adds, subtracts,
# reciprocals, square roots and transcendentals one each, an fma two;
# comparisons and integers uncounted).  A box's slab test: per axis o_l (6),
# d_l (5), 1 / d_l (1), t_a, t_b (4).  A triangle's test up to its exit:
# the P vector and det (14); 1 / det, the T vector and u (10); Q and v (15);
# u + v (1); t (6).  A hit slot's anchor terms (13); an event of the walk
# (4).  The fan: a ray (80 over the three passes), a sphere's keep test (37),
# an instance sphere's pad under bfloat16 operands (15: |c| 6, the two terms
# and their sum 9).
PER_RAY_BOX_OPS = 48
PER_RAY_TRI_STEPS = (14, 10, 15, 1, 6)
PER_RAY_SLOT_OPS, PER_RAY_EVENT_OPS = 13, 4
PER_RAY_FAN_RAY_OPS, PER_RAY_FAN_SPHERE_OPS, PER_RAY_FAN_PAD_OPS = 80, 37, 15
PER_RAY_TIMED_CALLS = 20              # kernel calls a CUDA graph holds
PER_RAY_SCENES = ("carpet", "grass", "plush")


def log(msg):
    print(msg, flush=True)


def time_ms(fn, iters=20, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=50, replays=3):
    """The card's time per call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times, best replay over ``iters``.  No
    host dispatch is left in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    del graph
    return best


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def model_config(matmul_precision, compute_dtype="bfloat16"):
    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n,
                "matmul_precision": matmul_precision}

    return {"module": "network.model.ParamNerf", "pos_embedding": ff(10),
            "dir_embedding": ff(4), "param_embedding": ff(4), "n_parameters": [1, 6],
            "compute_dtype": compute_dtype}


def renderer_config(matmul_precision):
    """scripts/bench_render.build's render config at bench.py's settings and
    the carpet operating point (nerftex_tpu/operating_points.py)."""
    return {
        "module": "network.renderer.InstanceRenderer",
        "n_samples": 1024, "render_chunk": 262144, "net_chunk": 32768,
        "step_size": 0.002, "sample_budget_per_ray": 0, "sorted_blocks": True,
        "instancer_config": {
            "module": "instancer.instancer.Instancer",
            "b_0": [-1.4, -1.2, -0.1], "b_1": [1.2, 1.2, 1.8],
            "cast_shadow_rays": False,
            "textures": ["meshes/smooth_checkerboard.png", "", "", "", "light"],
            "mesh_path": "meshes/cloth_mesh.ply",
            "patch_origins_path": "meshes/cloth_anchor_points.ply",
            "patch_scale": 0.09, "jitter_amount": 1.0,
            "instance_sampling_method": "nearest",
            "max_hits": 48, "ray_block": 1024, "max_steps_per_ray": 320,
            "cull_budget": 448, "tri_cull_budget": 384,
            "matmul_precision": matmul_precision,
        },
    }


def plush_model_config():
    """configs/config_plush_render.py's ParamNerf in bf16, with the TPU's
    bf16 operands in the Fourier lift (as the golden was rendered)."""
    def ff(n):
        return {"module": "network.model.FourierFeatures", "n_freq_bands": n,
                "matmul_precision": "bfloat16"}

    return {"module": "network.model.ParamNerf", "pos_embedding": ff(10),
            "dir_embedding": ff(4), "param_embedding": ff(4), "n_parameters": [1, 4],
            "param_depth": 0, "color_depth": 1, "compute_dtype": "bfloat16"}


def plush_renderer_config():
    """configs/config_plush_render.py's renderer and instancer with the plush
    operating point (nerftex_tpu/operating_points.py) and the flags that
    wrote tests/golden_scene_plush.npz (scripts/ab_round3e.sh: the whole
    frame in one render chunk, ray block 2048)."""
    return {
        "module": "network.renderer.InstanceRenderer",
        "n_samples": 1280, "render_chunk": 640000, "net_chunk": 65536, "step_size": 0.0005,
        "density_reweighting": True, "sorted_blocks": True,
        "instancer_config": {
            "module": "instancer.instancer.Instancer",
            "b_0": [-1.1, -1.1, -0.2], "b_1": [1.1, 1.1, 1.1], "cast_shadow_rays": True,
            "textures": ["", "meshes/checkerboard.png", "light"],
            "mesh_path": "meshes/stanford_bunny.ply", "patch_scale": 0.04,
            "min_shadow_samples": 4, "n_shadow_samples": 128, "min_texture_samples": 4,
            "n_texture_samples": 128, "jitter_amount": 0.3,
            "instance_sampling_method": "nearest_blend",
            "ray_block": 2048, "max_hits": 128, "max_steps_per_ray": 1280,
            "cull_budget": 384, "tri_cull_budget": 1024, "shadow_cull_budget": 768,
            "shadow_tri_cull_budget": 1536, "pallas_selk": True,
            "matmul_precision": "bfloat16",
        },
    }


def grass_model_config():
    """configs/config_grass_render.py's ParamNerf in bf16 (the grass
    operating point's compute dtype), with the TPU's bf16 operands in the
    Fourier lift (as the golden was rendered)."""
    from configs.config_grass_render import config

    cfg = dict(config["model_config"], compute_dtype="bfloat16")
    for k in ("pos_embedding", "dir_embedding", "param_embedding"):
        cfg[k] = dict(cfg[k], matmul_precision="bfloat16")
    return cfg


def grass_renderer_config():
    """configs/config_grass_render.py's renderer and instancer at the port's
    grass operating point (nerftex_torch.operating_points) and the flags
    that wrote tests/golden_scene_grass.npz (scripts/ab_round3e.sh: ray
    block 2048, max_hits 96, step cap 1024, culls 512/1024, shadow culls
    512/2048, the whole frame in one render chunk), with the slab test's
    bf16 operands."""
    from configs.config_grass_render import config
    from nerftex_torch.operating_points import resolve

    op = resolve("grass")
    cfg = dict(config["renderer_config"], **op["renderer"], render_chunk=512 * 512)
    cfg["instancer_config"] = dict(cfg["instancer_config"], **op["instancer"],
                                   matmul_precision="bfloat16")
    return cfg


def npz_params(name):
    """The transplanted ParamNerf weights in tests/<name>."""
    inp = np.load(os.path.join(ROOT, "tests", name))
    return {k[len("param/"):]: inp[k] for k in inp.files if k.startswith("param/")}


# Each scene frame's golden's box-downsampling factor
# (scripts/bench_scene.py _downsample_factor).
DOWNSAMPLE = {"plush": 10, "grass": 8, "carpet": 8, "carpet10k": 8}


def proxy_box(scene):
    """The proxy box (b_0, b_1) of configs/config_<scene>_render.py's test
    dataset."""
    import importlib

    cfg = importlib.import_module(f"configs.config_{scene}_render").config
    proxy = cfg["test_dataset_config"]["proxy_config"]
    return proxy["b_0"], proxy["b_1"]


def scene_data(scene):
    """A scene frame's rays (the JAX test dataset's first item, from the
    camera in tests/torch_<scene>_inputs.npz), weights and size."""
    import math

    from nerftex_torch.ops.rays import frame_rays

    npz = f"torch_{scene}_inputs.npz"
    inp = np.load(os.path.join(ROOT, "tests", npz))
    h, w, angle = int(inp["height"]), int(inp["width"]), float(inp["angle"])
    data = frame_rays(h, w, inp["eye"], angle, inp["parameters"], *proxy_box(scene),
                      focal=w / math.tan(angle / 2) / 2)
    return data, npz_params(npz), h, w


def scene_golden_psnr(scene, color, alpha, h, w):
    """scripts/bench_scene.py check_golden's comparison: the frame (color
    [h*w, 3] and alpha [h*w], premultiplied) box-downsampled by the scene's
    factor against the float16 golden tests/golden_scene_<scene>.npz."""
    color = np.asarray(color, np.float32)
    alpha = np.asarray(alpha, np.float32)
    if color.shape != (h * w, 3) or alpha.shape != (h * w,):
        raise AssertionError(f"{scene} frame shapes {color.shape} {alpha.shape}")
    if not (np.isfinite(color).all() and np.isfinite(alpha).all()):
        raise AssertionError(f"{scene} frame has non-finite values")
    f = DOWNSAMPLE[scene]
    frame = np.concatenate([color.reshape(h, w, 3), alpha.reshape(h, w, 1)], -1)
    small = frame.reshape(h // f, f, w // f, f, 4).mean((1, 3))
    g = np.load(os.path.join(ROOT, "tests", f"golden_scene_{scene}.npz"))["frame"]
    g = g.astype(np.float32)
    if g.shape != small.shape:
        raise AssertionError(f"{scene} golden {g.shape} != frame {small.shape}")
    return 10 * np.log10(1.0 / max(float(np.mean((small - g) ** 2)), 1e-12))


def frame_psnr(scene, out, h, w):
    """scene_golden_psnr of a renderer's output."""
    return scene_golden_psnr(scene, out["color_pred"][0].float().cpu().numpy(),
                             out["alpha_pred"][0].float().cpu().numpy(), h, w)


def golden_psnr(out):
    """bench.py _check_golden's comparison."""
    color = out["color_pred"][0].float().cpu().numpy()
    alpha = out["alpha_pred"][0].float().cpu().numpy()
    if color.shape != (512 * 512, 3) or alpha.shape != (512 * 512,):
        raise AssertionError(f"frame shapes {color.shape} {alpha.shape}")
    if not (np.isfinite(color).all() and np.isfinite(alpha).all()):
        raise AssertionError("frame has non-finite values")
    g = np.load(os.path.join(ROOT, "tests", "golden_bench_frame.npz"))
    err = np.concatenate([color - g["color"].astype(np.float32),
                          alpha[:, None] - g["alpha"].astype(np.float32)[:, None]], -1)
    return 10 * np.log10(1.0 / max(float(np.mean(err * err)), 1e-12))


def tex_shape_row(tex_gather, tex, quads, uv, label):
    """Both variants of the texture fetch of channel ``tex`` (its byte
    quads ``quads``) at ``uv`` against the plain version, bit for bit;
    times of the byte_quad variant the frames run, the f32 variant and
    grid_sample, and the bound."""
    w, h = tex.shape
    image = tex.T.reshape(1, 1, h, w)
    n = uv.shape[0]
    ref = tex_gather.sample_channel_plain(tex, uv)
    err = 0.0
    for variant, q, plain in (("byte_quad", quads, tex_gather.fetch_quads_plain(quads, w, h, uv)),
                              ("f32", None, ref)):
        got = tex_gather.sample_channel(tex, uv, q)
        torch.cuda.synchronize()
        if not (torch.equal(got, ref) and torch.equal(got, plain)):
            raise AssertionError(f"tex_fetch {variant} on {label} disagrees with its plain "
                                 f"version: max {float((got - ref).abs().max())}")
        err = max(err, float((got - plain).abs().max()))
    grid = (uv * 2 - 1).reshape(1, 1, -1, 2)

    def library():
        return torch.nn.functional.grid_sample(image, grid, mode="bilinear",
                                               padding_mode="border", align_corners=True)

    lib_err = float((library().reshape(-1) - ref).abs().max())
    nbytes = n * (8 + 4) + quads.numel()
    row = {
        "samples": n, "max_abs_err": err,
        "ms": time_ms(lambda: tex_gather.sample_channel(tex, uv, quads), iters=50),
        "device_ms": device_ms(lambda: tex_gather.sample_channel(tex, uv, quads)),
        "f32_variant_device_ms": device_ms(lambda: tex_gather.sample_channel(tex, uv)),
        "plain_ms": time_ms(lambda: tex_gather.fetch_quads_plain(quads, w, h, uv), iters=50),
        "bound_ms": max(nbytes / H100_BYTES_PER_S, n * 20 / H100_F32_FLOPS) * 1e3,
        "bound_by": "bytes",
        "library_ms": time_ms(library, iters=50),
        "library_device_ms": device_ms(library),
        "library_max_abs_err": lib_err,
    }
    log(f"tex_fetch ({label}, {n} samples): byte_quad and f32 bit-equal to plain; "
        f"byte_quad device {row['device_ms']:.4f} ms (dispatch {row['ms']:.4f}), f32 device "
        f"{row['f32_variant_device_ms']:.4f} ms, grid_sample device "
        f"{row['library_device_ms']:.4f} ms (dispatch {row['library_ms']:.4f}), bound "
        f"{row['bound_ms']:.4f} ms")
    return row


def tex_kernel_row(shapes, texture):
    """The kernels-line row of tex_fetch: the first of ``shapes`` (rows of
    tex_shape_row), the others riding along."""
    return dict(shapes[0], name="tex_fetch", route="cuda", variant="byte_quad",
                source="nerftex_torch/kernels/csrc/tex_fetch.cu",
                replaces="nerftex_tpu/kernels/tex_gather.py:121",
                library="torch.nn.functional.grid_sample (bilinear, border, align_corners)",
                texture=texture, shapes=shapes[1:])


def check_tex(tex_gather, channel, texture):
    """The texture fetch on one channel of ``texture`` against the plain
    version (tex_shape_row) at uv samples that reach past the borders, at
    each of TEX_SAMPLES."""
    dev = torch.device("cuda")
    tex = torch.tensor(channel, device=dev).contiguous()
    quads = tex_gather.byte_quads(tex)
    if quads is None:
        raise AssertionError(f"{texture} is not byte valued")
    shapes = []
    for n in TEX_SAMPLES:
        rs = np.random.RandomState(0)
        uv = torch.tensor(rs.uniform(-0.05, 1.05, (n, 2)).astype(np.float32), device=dev)
        shapes.append(tex_shape_row(tex_gather, tex, quads, uv, texture))
    return tex_kernel_row(shapes, texture)


def selk_tensors(tk0, tk1, kvalid, sel_a, sel_b, t_pt, u_sel):
    """numpy overlap-resolution inputs as the kernel's CUDA tensors."""
    dev = torch.device("cuda")

    def f32(x):
        return torch.tensor(x.astype(np.float32), device=dev)

    return (f32(tk0), f32(tk1), torch.tensor(kvalid, device=dev), f32(sel_a), f32(sel_b),
            f32(t_pt), f32(u_sel))


def selk_inputs(rb, s, k):
    """Overlap-resolution inputs at the plush shapes, made from a numpy
    seed in the render path's layout: each ray's valid hit slots are a
    prefix, ascending in tk0 (one ray in 16 has none), and samples spread
    over [0, 3] so some fall outside every interval."""
    rs = np.random.RandomState(3)
    n_valid = rs.randint(1, k + 1, rb)
    n_valid[::16] = 0
    slot = np.arange(k)[None, :]
    kvalid = slot < n_valid[:, None]
    tk0 = np.sort(rs.uniform(0.0, 2.5, (rb, k)), -1)
    tk1 = tk0 + rs.uniform(0.01, 0.3, (rb, k))
    tk0, tk1 = np.where(kvalid, tk0, np.inf), np.where(kvalid, tk1, np.inf)
    c = rs.uniform(0.0, 2.5, (rb, k))
    sel_a = c * c + rs.uniform(0.0, 0.01, (rb, k))
    t_pt = rs.uniform(0.0, 3.0, (rb, s))
    u_sel = rs.uniform(size=(rb, s))
    return selk_tensors(tk0, tk1, kvalid, sel_a, -c, t_pt, u_sel)


def selk_render_inputs(rb, s, k):
    """Overlap-resolution inputs as a sorted block of the render path lays
    them out: each ray's valid slots a prefix ascending in tk0 (tk0 = tk1 =
    +inf past it; one ray in 16 has none, one in 5 fills all K), and t
    increasing along S from just before the first interval, through the
    gaps between intervals, to past the last one for the last quarter of
    the samples (a block's padded samples)."""
    rs = np.random.RandomState(4)
    n_valid = rs.randint(1, k + 1, rb)
    n_valid[1::5] = k
    n_valid[::16] = 0
    kvalid = np.arange(k)[None, :] < n_valid[:, None]
    tk0 = np.sort(rs.uniform(0.5, 2.5, (rb, k)), -1)
    tk1 = tk0 + rs.uniform(0.01, 0.3, (rb, k))
    first = np.where(n_valid > 0, tk0[:, 0], 0.5) - 0.05
    last = np.where(kvalid, tk1, -np.inf).max(-1)
    last = np.where(n_valid > 0, last, 2.5)
    step = (last - first) / (0.75 * s)
    t_pt = first[:, None] + step[:, None] * (np.arange(s) + rs.uniform(0.0, 1.0, (rb, s)))
    tk0, tk1 = np.where(kvalid, tk0, np.inf), np.where(kvalid, tk1, np.inf)
    c = rs.uniform(0.5, 2.5, (rb, k))
    sel_a = c * c + rs.uniform(0.0, 0.01, (rb, k))
    return selk_tensors(tk0, tk1, kvalid, sel_a, -c, t_pt, rs.uniform(size=(rb, s)))


def selk_work(tk0, tk1, kvalid, t_pt):
    """What one selk_resolve launch needs on these inputs, as a device
    tensor [window slots, search steps, valid slots], read only when asked.
    A sample's answer lies in its stabbing window.  For a ray in render
    layout (valid slots a prefix, tk0 non-decreasing, each finite with tk0
    < tk1) that is the slots from the first whose prefix max of tk1 exceeds
    t to the last with tk0 <= t, found by two binary searches, and at least
    the one fallback slot.  Any other ray has to look at each valid slot
    (at least one)."""
    K = kvalid.shape[-1]
    n_valid = kvalid.sum(-1)
    prefix = (kvalid == (torch.arange(K, device=kvalid.device) < n_valid[:, None])).all(-1)
    t0 = torch.where(kvalid, tk0, float("inf"))
    t1 = torch.where(kvalid, tk1, -float("inf"))
    finite = torch.where(kvalid, torch.isfinite(tk0) & torch.isfinite(tk1) & (tk0 < tk1),
                         True).all(-1)
    flagged = prefix & finite & (t0[:, 1:] >= t0[:, :-1]).all(-1)
    t = t_pt.contiguous()
    hi = torch.searchsorted(t0.contiguous(), t, right=True)
    lo = torch.searchsorted(torch.cummax(t1, -1).values.contiguous(), t, right=True)
    slots = torch.where(flagged[:, None], (hi - lo).clamp(min=1), n_valid.clamp(min=1)[:, None])
    steps = (flagged * 2 * torch.ceil(torch.log2(n_valid + 1.0))).long().sum() * t.shape[1]
    return torch.stack([slots.sum(), steps, n_valid.sum()])


def selk_bound(rb, s, k, method, work):
    """(bound ms, what bounds it) of one selk_resolve launch whose inputs
    need ``work`` = (window slots, search steps, valid slots), from
    selk_work.  Bytes, each once: the planes read (t, and u unless nearest)
    and the three written, the validity table, and a record of each valid
    slot (tk0, tk1, and sel_a, sel_b unless random).  Operations:
    SELK_OPS_PER_SLOT per window slot and SELK_OPS_PER_STEP per search
    step."""
    slots, steps, valid = work
    planes = 4 if method == "nearest" else 8
    record = 8 if method == "random" else 16
    t_bytes = (rb * s * (planes + 12) + rb * k + valid * record) / H100_BYTES_PER_S
    t_ops = (SELK_OPS_PER_SLOT * slots + SELK_OPS_PER_STEP * steps) / H100_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops > t_bytes else "bytes"


def compare_selk(selk, args, method, blend):
    """The kernel against its plain version on ``args`` (compare_selk_outputs)."""
    got = selk.selk_resolve(*args, method=method, blend_range=blend)
    return compare_selk_outputs(selk, got, args, method, blend)


def compare_selk_outputs(selk, got, args, method, blend):
    """The kernel's outputs ``got`` on ``args`` against its plain version's:
    n_active equal, nearest/random picks equal, nearest_blend picks equal
    off knife edges, p_sel within SELK_P_RTOL where the picks agree.
    Returns the counts."""
    ref = selk.selk_resolve_plain(*args, method=method, blend_range=blend)
    torch.cuda.synchronize()
    sel, p, n = got
    r_sel, r_p, r_n = ref
    if not torch.equal(n, r_n):
        raise AssertionError(f"selk_resolve {method}: n_active differs")
    same = sel == r_sel
    n_mism = int((~same).sum())
    max_edge = 0.0
    if method != "nearest_blend" and n_mism:
        raise AssertionError(f"selk_resolve {method}: {n_mism} picks differ")
    if n_mism:
        # Knife edges: u within SELK_EDGE of a value of the plain cumsum.
        r, c = torch.nonzero(~same, as_tuple=True)
        cum = blend_cum(selk, [a[r] for a in args[:5]], args[5][r, c], blend)
        max_edge = float((args[6][r, c][:, None] - cum).abs().min(-1).values.max())
        if not max_edge <= SELK_EDGE:
            raise AssertionError(f"selk_resolve nearest_blend: {n_mism} picks differ off "
                                 f"knife edges (max distance {max_edge})")
    p_err = float((p[same] - r_p[same]).abs().max())
    if not torch.allclose(p[same], r_p[same], rtol=SELK_P_RTOL, atol=1e-7):
        raise AssertionError(f"selk_resolve {method}: p_sel off by {p_err}")
    return {"mismatches": n_mism, "max_knife_edge": max_edge, "max_abs_err": p_err}


def check_selk(selk, frame):
    """The selk_resolve kernel against its plain version at ``frame``'s
    check shape, for each method given, with times of the frame's method
    (the last one) and the bound; then at the render-layout inputs of each
    of the frame's hit tiers, every method, with device times."""
    rb, s, k = SELK_SHAPE[frame]
    args = selk_inputs(rb, s, k)
    work = selk_work(*args[:3], args[5]).tolist()
    blend = SELK_BLEND
    per_method = {}
    for method in SELK_METHODS[frame]:
        stats = compare_selk(selk, args, method, blend)
        bound_ms, bound_by = selk_bound(rb, s, k, method, work)
        per_method[method] = dict(stats, bound_ms=bound_ms, bound_by=bound_by,
                                  ms=time_ms(lambda: selk.selk_resolve(*args, method=method,
                                                                       blend_range=blend)),
                                  device_ms=device_ms(lambda: selk.selk_resolve(
                                      *args, method=method, blend_range=blend)),
                                  plain_ms=time_ms(lambda: selk.selk_resolve_plain(
                                      *args, method=method, blend_range=blend), iters=3,
                                      warmup=1))
        log(f"selk_resolve {method}: {rb}x{s}x{k}, picks differing {stats['mismatches']} of "
            f"{args[5].numel()} (max knife edge {stats['max_knife_edge']:.3g}), max |p - plain| "
            f"{stats['max_abs_err']:.3g}, kernel {per_method[method]['ms']:.4f} ms (device "
            f"{per_method[method]['device_ms']:.4f}), plain {per_method[method]['plain_ms']:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
    main = per_method[SELK_METHODS[frame][-1]]
    render = []
    for shape in SELK_RENDER_SHAPES[frame]:
        r_args = selk_render_inputs(*shape)
        r_work = selk_work(*r_args[:3], r_args[5]).tolist()
        row = {"shape": list(shape), "window_slots": r_work[0], "valid_slots": r_work[2]}
        for method in selk.METHODS:
            row[method] = dict(compare_selk(selk, r_args, method, blend),
                               device_ms=device_ms(lambda: selk.selk_resolve(
                                   *r_args, method=method, blend_range=blend), iters=20),
                               bound_ms=selk_bound(*shape, method, r_work)[0])
        log(f"selk_resolve render layout {'x'.join(map(str, shape))}: "
            + ", ".join(f"{m} device {row[m]['device_ms']:.4f} ms, bound {row[m]['bound_ms']:.4f} "
                        f"({row[m]['mismatches']} picks differ)" for m in selk.METHODS))
        render.append(row)
    row = {
        "name": "selk_resolve", "route": "cuda",
        "source": "nerftex_torch/kernels/csrc/selk_resolve.cu",
        "replaces": "nerftex_tpu/kernels/selk_resolve.py:144",
        "max_abs_err": main["max_abs_err"], "ms": main["ms"], "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
        "library_ms": None,
        "shape": [rb, s, k], "window_slots": work[0], "valid_slots": work[2],
        "methods": per_method, "render_layout": render,
    }
    log(f"selk_resolve: bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


@contextlib.contextmanager
def selk_capture(keep_inputs=False):
    """While active, record each selk_resolve call of the render path (the
    calls nerftex_torch.instancing.device makes) in the list it yields: a
    dict of the launch's key (Rb, S, K, method), its selk_work (left on the
    device, so recording adds no host sync) and, with ``keep_inputs``, its
    arguments cloned ("args": positional, keywords)."""
    import nerftex_torch.instancing.device as device

    real = device.selk_resolve
    calls = []

    def capture(*a, **k):
        tk0, tk1, kvalid, t_pt = a[0], a[1], a[2], a[5]
        call = {"key": (tk0.shape[0], t_pt.shape[1], tk0.shape[1], k["method"]),
                "work": selk_work(tk0, tk1, kvalid, t_pt)}
        if keep_inputs:
            call["args"] = (tuple(None if x is None else x.clone() for x in a), k)
        calls.append(call)
        return real(*a, **k)

    device.selk_resolve = capture
    try:
        yield calls
    finally:
        device.selk_resolve = real


@contextlib.contextmanager
def mlp_wrap(call):
    """While active, every mlp_fused call of the render path (the one
    ParamNerf.infer makes) goes to call(kernel module, pos_map, dir_map,
    packed) instead."""
    import nerftex_torch.models.mlp as mlp

    real = mlp.fused

    class Proxy:
        """The kernel module as ParamNerf.infer sees it, but for mlp_fused."""

        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def mlp_fused(pos_map, dir_map, packed):
            return call(real, pos_map, dir_map, packed)

    mlp.fused = Proxy()
    try:
        yield
    finally:
        mlp.fused = real


@contextlib.contextmanager
def mlp_capture(every=False):
    """While active, keep a copy of the inputs (pos_map, dir_map, packed
    weights) of the render path's first mlp_fused call, or of every call
    with ``every``, in the list it yields."""
    calls = []

    def call(real, pos_map, dir_map, packed):
        if every or not calls:
            calls.append((pos_map.clone(), dir_map.clone(), packed))
        return real.mlp_fused(pos_map, dir_map, packed)

    with mlp_wrap(call):
        yield calls


@contextlib.contextmanager
def tex_capture():
    """While active, keep the inputs (channel, uv cloned as [N, 2], byte
    quads) of the render path's first tex_fetch call (the one
    nerftex_torch.instancing.device makes) in the list it yields."""
    import nerftex_torch.instancing.device as device

    real = device.sample_channel
    calls = []

    def capture(tex, uv, quads=None):
        if not calls:
            calls.append((tex, uv.reshape(-1, 2).clone(), quads))
        return real(tex, uv, quads)

    device.sample_channel = capture
    try:
        yield calls
    finally:
        device.sample_channel = real


@contextlib.contextmanager
def busiest_capture():
    """While active, keep the inputs of the compact path's kernel launches
    that hold the most real samples, chosen by the samples taken: of
    mlp_fused, the net_chunk of _shade_compact's packed rows with the
    most taken rows (each call's rows located by their offset in the
    _shade_compact call and read against inst["taken"]); of tex_fetch, the
    first launch of the ray block (_block_compact) that took the most
    samples.  Yields a dict: "mlp" [(pos_map, dir_map, packed)] and
    "mlp_taken" (taken rows, rows) of that chunk; "tex" [(channel, uv
    [N, 2], quads)] and "tex_taken" (the block's taken samples)."""
    from nerftex_torch.instancing.device import DeviceInstancer
    import nerftex_torch.instancing.device as device
    from nerftex_torch.render.instance_renderer import InstanceRenderer

    kept = {"mlp": [], "mlp_taken": (-1, 0), "tex": [], "tex_taken": -1}
    shade = {"taken": None, "offset": 0}
    block_tex = []
    real_shade, real_block = InstanceRenderer._shade_compact, DeviceInstancer._block_compact
    real_tex = device.sample_channel

    def shade_compact(self, inst, *args):
        shade.update(taken=inst["taken"], offset=0)
        try:
            return real_shade(self, inst, *args)
        finally:
            shade["taken"] = None

    def call(real, pos_map, dir_map, packed):
        if shade["taken"] is not None:
            n, off = pos_map.shape[0], shade["offset"]
            shade["offset"] = off + n
            taken = int(shade["taken"][off:off + n].sum())
            if taken > kept["mlp_taken"][0]:
                kept.update(mlp=[(pos_map.clone(), dir_map.clone(), packed)],
                            mlp_taken=(taken, n))
        return real.mlp_fused(pos_map, dir_map, packed)

    def block_compact(self, *args):
        block_tex.clear()
        out = real_block(self, *args)
        taken = int(out["taken"].sum())
        if block_tex and taken > kept["tex_taken"]:
            kept.update(tex=block_tex[:1], tex_taken=taken)
        block_tex.clear()
        return out

    def tex(channel, uv, quads=None):
        if not block_tex:
            block_tex.append((channel, uv.reshape(-1, 2).clone(), quads))
        return real_tex(channel, uv, quads)

    InstanceRenderer._shade_compact, DeviceInstancer._block_compact = shade_compact, block_compact
    device.sample_channel = tex
    try:
        with mlp_wrap(call):
            yield kept
    finally:
        InstanceRenderer._shade_compact, DeviceInstancer._block_compact = real_shade, real_block
        device.sample_channel = real_tex


def check_selk_frame(selk, calls, frame):
    """The selk_resolve kernel against its plain version on every launch of
    a frame, as captured (selk_capture with inputs kept): picks and n_active
    as compare_selk requires; the frame's launches timed together (event
    time, and replayed from one CUDA graph), the plain version's, and the
    summed bound, bound by what bounds the launches that hold most of it."""
    bound_by = {"bytes": 0.0, "operations": 0.0}
    mism, p_err, bound = 0, 0.0, 0.0
    works = torch.stack([c["work"] for c in calls]).tolist()
    for call, work in zip(calls, works):
        args, kw = call["args"]
        stats = compare_selk(selk, args, kw["method"], kw["blend_range"])
        mism += stats["mismatches"]
        p_err = max(p_err, stats["max_abs_err"])
        bound_ms, by = selk_bound(*call["key"], work)
        bound += bound_ms
        bound_by[by] += bound_ms

    def run(fn):
        return lambda: [fn(*c["args"][0], **c["args"][1]) for c in calls]

    total = {"ms": time_ms(run(selk.selk_resolve), iters=1, warmup=1),
             "device_ms": device_ms(run(selk.selk_resolve), iters=1),
             "plain_ms": time_ms(run(selk.selk_resolve_plain), iters=1, warmup=0),
             "bound_ms": bound}
    log(f"selk_resolve on the {frame} frame's {len(calls)} launches: {mism} picks differ, max "
        f"|p - plain| {p_err:.3g}; frame kernel device {total['device_ms']:.4f} ms (dispatch "
        f"{total['ms']:.4f}), plain {total['plain_ms']:.2f} ms, bound {total['bound_ms']:.4f} ms")
    return dict(total, name="selk_resolve", route="cuda", per="frame",
                source="nerftex_torch/kernels/csrc/selk_resolve.cu",
                replaces="nerftex_tpu/kernels/selk_resolve.py:144", max_abs_err=p_err,
                mismatches=mism, bound_by=max(bound_by, key=bound_by.get), library_ms=None)


def selk_frame_record(calls, launches, frame):
    """The frame's selk_resolve launches from selk_capture's ``calls``
    (which must number ``launches``, the wrapper's count): histogram rows
    [Rb, S, K, method, launches, window slots, valid slots], the work read
    in one transfer, and the summed bound."""
    if len(calls) != launches:
        raise AssertionError(f"{frame} frame: {len(calls)} selk_resolve calls captured, "
                             f"{launches} launched")
    works = torch.stack([c["work"] for c in calls]).tolist() if calls else []
    hist = {}
    bound = 0.0
    for call, work in zip(calls, works):
        n, w, v = hist.get(call["key"], (0, 0, 0))
        hist[call["key"]] = (n + 1, w + work[0], v + work[2])
        bound += selk_bound(*call["key"], work)[0]
    rows = [[*key, *vals] for key, vals in sorted(hist.items())]
    log(f"selk_resolve launches, {frame} frame ([Rb, S, K, method, launches, window slots, valid "
        f"slots]): {json.dumps(rows)}; summed bound {bound:.4f} ms")
    return {"launch_histogram": rows, "frame_bound_ms": bound}


def blend_cum(selk, tables, t, blend):
    """The plain version's nearest_blend cumsum [M, K] at single samples
    (tables [M, K], t [M]), for the knife-edge check."""
    tk0, tk1, kv, sa, sb = tables
    tp = t[:, None]
    active = kv & (tk0 <= tp) & (tp < tk1)
    iv = torch.where(kv, torch.maximum(tk0 - tp, tp - tk1).clamp(min=0), float("inf"))
    fb = torch.nn.functional.one_hot(iv.argmin(-1), tk0.shape[-1]).bool()
    active = torch.where((active.sum(-1) == 0)[:, None], fb, active)
    d2 = selk.anchor_d2(sa, sb, tp).clamp(min=0)
    dist = torch.where(active, d2.sqrt(), float("inf"))
    w = torch.where(active, (blend + dist.min(-1, keepdim=True).values - dist).clamp(min=0), 0.0)
    return torch.cumsum(w / w.sum(-1, keepdim=True).clamp(min=1e-20), -1)


def cublas_chain(packed, dtype=torch.bfloat16):
    """The packed layer chain as torch.nn.functional.linear calls (cuBLAS)
    in ``dtype`` (float32 with TF32 off), for timing only; it takes the
    padded pos and dir maps in ``dtype`` (cublas_inputs)."""
    from nerftex_torch.kernels import mlp_fused as fused

    layers = []
    for w_off, b_off, s0, k0, s1, k1, n_pad, dst, n_out, col, relu in packed.table.tolist():
        k = k0 + (k1 if s1 >= 0 else 0)
        w = packed.weights[w_off:w_off + k * n_pad].view(k, n_pad).T.contiguous().to(dtype)
        b = packed.biases[b_off:b_off + n_pad].to(dtype)
        layers.append((s0, s1, w, b, dst, relu))

    def run(pos, dirs):
        bufs = {fused.BUF_POS: pos, fused.BUF_DIR: dirs}
        outs = []
        for s0, s1, w, b, dst, relu in layers:
            x = torch.cat([bufs[s0], bufs[s1]], 1) if s1 >= 0 else bufs[s0]
            y = torch.nn.functional.linear(x, w, b)
            if relu:
                y = torch.relu(y)
            if dst == fused.OUT:
                outs.append(y)
            else:
                bufs[dst] = y
        return outs

    return run


def cublas_inputs(packed, pos_map, dir_map, dtype=torch.bfloat16):
    """The pos and dir maps padded to the packed widths, in ``dtype``."""
    pad = torch.nn.functional.pad
    return (pad(pos_map, (0, packed.pos_pad - packed.pos_dim)).to(dtype),
            pad(dir_map, (0, packed.dir_pad - packed.dir_dim)).to(dtype))


def mlp_bounds(packed, n_samples, dtype_name):
    """(bound ms, what bounds it, the bounds by operations) of one
    mlp_fused call on n_samples: bytes (maps, weights and biases read once,
    [N, 4] written) over the memory rate, and operations over the peak of
    the variant's type.  bf16: 2 x macs at the bf16 tensor rate.  f32:
    wgmma_tf32x3 runs TF32X3_PRODUCTS TF32 products per multiply-add, its
    bound; the same f32 work on the FMA pipes would take 2 x macs at the f32
    rate (bound_fma_f32_ms)."""
    elt = 2 if dtype_name == "bfloat16" else 4
    nbytes = (n_samples * (packed.pos_pad + packed.dir_pad) * elt
              + packed.weights.numel() * elt + packed.biases.numel() * 4 + n_samples * 16)
    flops = 2 * packed.macs * n_samples
    if dtype_name == "bfloat16":
        ops = {"bound_ops_ms": flops / H100_BF16_FLOPS * 1e3}
    else:
        ops = {"bound_tf32x3_ms": TF32X3_PRODUCTS * flops / H100_TF32_FLOPS * 1e3,
               "bound_fma_f32_ms": flops / H100_F32_FLOPS * 1e3}
    t_ops = next(iter(ops.values()))
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    return max(t_bytes, t_ops), "operations" if t_ops > t_bytes else "bytes", ops


def mlp_row(fused, packed, pos_map, dir_map, dtype_name, label):
    """The fused MLP against its plain version on the feature maps
    (pos_map, dir_map), with times of the kernel, the plain version and the
    cuBLAS layer chain in the same dtype, and the bound (mlp_bounds)."""
    n_samples = pos_map.shape[0]
    with torch.no_grad():
        got = fused.mlp_fused(pos_map, dir_map, packed)
        ref = fused.mlp_fused_plain(pos_map, dir_map, packed)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"mlp_fused {dtype_name} ({label}): non-finite output")
    scale = max(1.0, float(ref.abs().max()))
    err = float((got - ref).abs().max())
    mean_err = float((got - ref).abs().mean())
    tol = (MLP_BF16_TOL if dtype_name == "bfloat16" else MLP_F32_TOL) * scale
    log(f"mlp_fused {dtype_name} ({label}): N={n_samples}, dir map {packed.dir_dim} wide (padded "
        f"{packed.dir_pad}), max |kernel - plain| = {err:.3g} (tol {tol:.3g}, max|plain| "
        f"{scale:.3g}), mean err {mean_err:.3g}")
    if not err <= tol:
        raise AssertionError(f"mlp_fused {dtype_name} ({label}) disagrees with its plain version: "
                             f"{err}")
    bound_ms, bound_by, op_bounds = mlp_bounds(packed, n_samples, dtype_name)
    flops = 2 * packed.macs * n_samples
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    run = cublas_chain(packed, dtype)
    pos_c, dir_c = cublas_inputs(packed, pos_map, dir_map, dtype)
    row = {
        "samples": n_samples, "max_abs_err": err, "mean_abs_err": mean_err,
        "ms": time_ms(lambda: fused.mlp_fused(pos_map, dir_map, packed)),
        "device_ms": device_ms(lambda: fused.mlp_fused(pos_map, dir_map, packed), iters=20),
        "plain_ms": time_ms(lambda: fused.mlp_fused_plain(pos_map, dir_map, packed)),
        "bound_ms": bound_ms, "bound_by": bound_by, **op_bounds,
        "library_ms": None,
        "macs_per_sample": packed.macs,
        "cublas_layers_ms": time_ms(lambda: run(pos_c, dir_c)),
        "cublas_layers_device_ms": device_ms(lambda: run(pos_c, dir_c), iters=20),
    }
    row["tflops"] = flops / row["device_ms"] / 1e9
    log(f"mlp_fused {dtype_name} ({label}): N={n_samples} kernel device {row['device_ms']:.4f} ms "
        f"({row['tflops']:.1f} TFLOP/s, {row['bound_ms'] / row['device_ms']:.3f} of the bound), "
        f"dispatch {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({', '.join(f'{k} {v:.4f}' for k, v in op_bounds.items())}), "
        f"cuBLAS {dtype_name} layers device {row['cublas_layers_device_ms']:.4f} ms (dispatch "
        f"{row['cublas_layers_ms']:.4f})")
    return row


def mlp_kernel_row(fused, packed, shapes):
    """The kernels-line row of mlp_fused: the first of ``shapes`` (rows of
    mlp_row), the others riding along."""
    return dict(shapes[0], name="mlp_fused", route="cuda", variant=fused.VARIANTS[packed.dtype],
                source="nerftex_torch/kernels/csrc/mlp_fused.cu",
                replaces="nerftex_tpu/kernels/mlp_pallas.py:119", shapes=shapes[1:])


def check_mlp(fused, model, dtype_name, sizes):
    """The fused MLP of ``model`` (compute dtype ``dtype_name``) against its
    plain version on random encodable inputs of each of ``sizes`` samples;
    the row is the first size's, the others ride along in ``shapes``."""
    dev = torch.device("cuda")
    n_prm = model.n_geo + model.n_app
    packed = model.packed()
    shapes = []
    for n_samples in sizes:
        rs = np.random.RandomState(1)
        pos = torch.tensor(rs.uniform(-1, 1, (n_samples, 3)).astype(np.float32), device=dev)
        dirs = torch.tensor(rs.normal(size=(n_samples, 3)).astype(np.float32), device=dev)
        dirs = dirs / dirs.norm(dim=-1, keepdim=True)
        prms = torch.tensor(rs.uniform(0, 1, (n_samples, n_prm)).astype(np.float32), device=dev)
        with torch.no_grad():
            pos_map, dir_map = model.feature_maps(pos, dirs, prms)
        shapes.append(mlp_row(fused, packed, pos_map, dir_map, dtype_name,
                              f"{n_prm} parameters, random inputs"))
    return mlp_kernel_row(fused, packed, shapes)


def bf16_dots(config):
    """A render config with the TPU goldens' bf16-operand dots:
    matmul_precision="bfloat16" in the three Fourier embeddings and the
    instancer (as grass_model_config and grass_renderer_config set them)."""
    model = dict(config["model_config"])
    for k in ("pos_embedding", "dir_embedding", "param_embedding"):
        model[k] = dict(model[k], matmul_precision="bfloat16")
    renderer = dict(config["renderer_config"])
    renderer["instancer_config"] = dict(renderer["instancer_config"], matmul_precision="bfloat16")
    return dict(config, model_config=model, renderer_config=renderer)


def carpet_configs(scene):
    """configs/config_<scene>_render.py's ParamNerf and renderer at the
    carpet operating point (nerftex_torch.operating_points: block 1024,
    max_hits 48, step cap 320, culls 448/384, bf16) and its golden's flags
    (scripts/ab_round3e.sh:35-36 for carpet, scripts/ab.py's carpet10k
    preset: the whole frame in one render chunk), with the golden's bf16
    dots (bf16_dots)."""
    import importlib

    from nerftex_torch.operating_points import resolve

    config = bf16_dots(importlib.import_module(f"configs.config_{scene}_render").config)
    op = resolve(scene)
    model = dict(config["model_config"], compute_dtype=op["compute_dtype"])
    renderer = dict(config["renderer_config"], **op["renderer"], render_chunk=512 * 512)
    renderer["instancer_config"] = dict(renderer["instancer_config"], **op["instancer"])
    return model, renderer


def config_item(scene, index=0):
    """Item ``index`` of configs/config_<scene>_render.py's test dataset,
    built by the port's data layer (Dataset over GenerateData, Full
    pixels, Proxy rays) after the config's seed, as scripts/bench_scene.py
    takes its frame; with the frame's height and width."""
    import importlib

    from nerftex_torch.utils import rng
    from nerftex_torch.utils.util import instantiate

    config = importlib.import_module(f"configs.config_{scene}_render").config
    rng.set_seed(config["seed"])
    ds = instantiate(config["test_dataset_config"])
    return list(ds.take(index + 1))[index], ds.height, ds.width


def carpet_frame(scene, params, counts, card):
    """The 512x512 frame of configs/config_<scene>_render.py (carpet or
    carpet10k) at the carpet operating point and its golden's flags
    (carpet_configs), on the config dataset's first item (config_item),
    with the bench weights (the configs initialise them) and JAX's draws
    for key(1); gated at CARPET_GOLDEN_PSNR_DB against
    tests/golden_scene_<scene>.npz on the 8x box downsample, timed (best
    of 2), with its peak device memory.  Each kernel against its plain
    version at the frame's inputs: tex_fetch on its first launch, mlp_fused
    on its first net_chunk, selk_resolve on every launch.  Returns the
    frame's numbers, its kernels' rows and its launch counts."""
    from nerftex_torch.kernels import mlp_fused as fused, selk_resolve as selk, tex_gather
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils import jax_rng
    from nerftex_torch.utils.util import instantiate

    reset_counts, read_counts, check_counts = counts
    data, h, w = config_item(scene)
    model_cfg, renderer_cfg = carpet_configs(scene)
    model = instantiate(model_cfg, device="cuda")
    load_jax_params(model, params)
    t0 = time.perf_counter()
    renderer = instantiate(dict(renderer_cfg, model=model, device="cuda"))
    build_s = time.perf_counter() - t0
    n_instances = renderer.instancer.n_instances()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with selk_capture(keep_inputs=True) as selk_calls, mlp_capture() as mlp_calls, \
            tex_capture() as tex_calls, overflow_capture() as drops:
        out = renderer(**data, key=jax_rng.key(1))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, variants = read_counts()
    log(f"{scene} frame ({n_instances} instances, scene build {build_s:.2f} s, first render "
        f"{first_s:.2f} s): launches {launches}, variants {variants}; dropped (hits, samples) "
        f"{drops} (gate {CARPET_DROPS[scene]})")
    check_counts(scene, launches, variants)
    if drops != [CARPET_DROPS[scene]]:
        raise AssertionError(f"the {scene} frame dropped {drops}, not {CARPET_DROPS[scene]}")
    psnr = frame_psnr(scene, out, h, w)
    log(f"{scene} golden check: {psnr:.2f} dB (floor {CARPET_GOLDEN_PSNR_DB}, 8x downsample)")
    if not psnr >= CARPET_GOLDEN_PSNR_DB:
        raise AssertionError(f"{scene} frame diverged from golden: {psnr:.2f} dB")
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        renderer(**data, key=jax_rng.key(1))
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{scene} frame: best of 2 warm renders {best * 1e3:.1f} ms -> {h * w / best:.1f} rays/s, "
        f"peak device memory {peak:.2f} GiB on {card}")
    tex, uv, quads = tex_calls[0]
    packed = mlp_calls[0][2]
    rows = {
        "tex_fetch": tex_kernel_row([tex_shape_row(tex_gather, tex, quads, uv,
                                                   f"the {scene} frame's first launch")],
                                    "smooth_checkerboard.png"),
        "mlp_fused": mlp_kernel_row(fused, packed, [mlp_row(
            fused, packed, *mlp_calls[0][:2], "bfloat16", f"the {scene} frame's first net_chunk")]),
        "selk_resolve": dict(check_selk_frame(selk, selk_calls, scene),
                             **selk_frame_record(selk_calls, launches["selk_resolve"], scene)),
    }
    frame = {"rays_per_s": h * w / best, "best_ms": best * 1e3, "golden_psnr_db": psnr,
             "peak_gib": peak, "first_render_s": first_s, "instances": n_instances}
    selk_calls.clear()
    mlp_calls.clear()
    tex_calls.clear()
    del renderer, model, out
    torch.cuda.empty_cache()
    return frame, rows, launches


@contextlib.contextmanager
def overflow_capture():
    """While active, the (dropped hits, dropped samples) of every
    InstanceRenderer call, as its _report_diagnostics reads them, go to the
    list it yields."""
    from nerftex_torch.render import instance_renderer

    cls = instance_renderer.InstanceRenderer
    real = cls._report_diagnostics
    drops = []

    def report(self, out):
        drops.append((int(out.get("_overflow_hits", 0)), int(out.get("_overflow_steps", 0))))
        return real(self, out)

    cls._report_diagnostics = report
    try:
        yield drops
    finally:
        cls._report_diagnostics = real


def main_render_mode(params, counts, card):
    """``python -m nerftex_torch.main configs/config_grass_filtered_render.py``
    at the config's own settings (512x512, f32 ParamNerf, render_chunk
    16384, n_samples 1024, blur_idx 0, MAIN_FRAMES frames), in process,
    with target_path a temporary directory whose checkpoints/ holds the
    grass_filtered weights in the JAX package's pickle layout (a config
    module there imports the shipped one and sets it); checked by
    check_render_mode with the pos 81 / dir 54 maps."""
    import tempfile

    from nerftex_torch.render.checkpoint import CheckpointManager, unflatten_params

    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_main_") as target:
        CheckpointManager(os.path.join(target, "checkpoints")).save(
            {"models": {"model": unflatten_params(params)}, "extra": {"step": 1}}, 1)
        return check_render_mode("grass_filtered", "config_grass_filtered_render", target, target,
                                 params, counts, card, (81, 54))


def check_render_mode(frame, stock, cfg_dir, target, params, counts, card, maps,
                      frame_mlp=False, want_drops=None):
    """``python -m nerftex_torch.main`` on configs/<stock>.py at its own
    settings, in process, through a config module in ``cfg_dir`` (under the
    repo) that sets target_path to ``target``, whose checkpoints/ holds
    the weights (``params`` in the JAX layout, or None: the latest
    checkpoint there).  Checks: the MAIN_FRAMES PNGs written; every
    mlp_fused launch wgmma_tf32x3, no tex_fetch; the first PNG within
    MAIN_U8_MAX_DIFF u8 levels of a direct render of the dataset's first
    item under stream_key(STREAM_PERTURB, 0); that render within
    MAIN_PLAIN_MAX_DIFF of the same render with mlp_fused routed to its
    plain version; the packed maps ``maps`` (pos, dir) wide; mlp_fused on
    the direct render's first net_chunk and selk_resolve on each of its
    launches against their plain versions.  ``frame_mlp``: the direct
    render's MLP launches, as captured, replayed from one graph beside the
    cuBLAS f32 chain and the summed bound.  ``want_drops``: the (hits,
    samples) each of main's frames must drop, the JAX package's for the
    same frames and keys; the direct render drops the first frame's.
    Returns the numbers, the kernels' rows and main's launch counts."""
    import importlib

    from nerftex_torch import main as port_main
    from nerftex_torch.kernels import mlp_fused as fused, selk_resolve as selk
    from nerftex_torch.render.checkpoint import CheckpointManager, load_jax_params
    from nerftex_torch.render.serve import straight_rgba
    from nerftex_torch.utils import rng
    from nerftex_torch.utils.image import decode_png_u8, encode_png
    from nerftex_torch.utils.util import instantiate

    reset_counts, read_counts, check_counts = counts
    config = importlib.import_module(f"configs.{stock}").config
    loader = config["test_dataset_config"]["data_loader_config"]
    h, w = loader["height"], loader["width"]
    if loader["dataset_size"] != MAIN_FRAMES:
        raise AssertionError(f"the config renders {loader['dataset_size']} frames")
    if params is None:
        params = CheckpointManager(os.path.join(target, "checkpoints")).restore_latest()[
            "models"]["model"]
    cfg_path = os.path.join(os.path.relpath(cfg_dir, ROOT), f"{frame}_render.py")
    with open(os.path.join(ROOT, cfg_path), "w") as f:
        f.write(f"from configs.{stock} import config as _config\n\n"
                f"config = dict(_config, target_path={target!r})\n")
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with overflow_capture() as main_drops:
        port_main.main([cfg_path])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches, variants = read_counts()
    log(f"nerftex_torch.main {cfg_path} ({MAIN_FRAMES} frames at {h}x{w}): {main_s:.2f} s -> "
        f"{MAIN_FRAMES * h * w / main_s:.1f} rays/s, peak device memory {peak:.2f} GiB; "
        f"launches {launches}, variants {variants}; dropped (hits, samples) per frame "
        f"{main_drops} on {card}")
    check_counts(f"{frame} (main)", launches, variants, idle=("tex_fetch",),
                 want=F32_FRAME_VARIANTS)
    media = os.path.join(target, "media", "test")
    names = sorted(os.listdir(media))
    if names != [f"{i}.png" for i in range(MAIN_FRAMES)]:
        raise AssertionError(f"nerftex_torch.main wrote {names}")
    images = []
    for name in names:
        with open(os.path.join(media, name), "rb") as f:
            images.append(decode_png_u8(f.read()).astype(np.int32))
        if images[-1].shape != (h, w, 4):
            raise AssertionError(f"{name} is {images[-1].shape}, not {h}x{w} RGBA")
    if all(img[..., 3].max() == 0 for img in images):
        raise AssertionError("every image nerftex_torch.main wrote is empty")

    # The direct render of the dataset's first item with the same key.
    rng.set_seed(config["seed"])
    data = list(instantiate(config["test_dataset_config"]).take(1))[0]
    model = instantiate(config["model_config"], device="cuda")
    load_jax_params(model, params)
    renderer = instantiate(dict(config["renderer_config"], model=model, device="cuda"))
    key = rng.stream_key(rng.STREAM_PERTURB, 0)
    reset_counts()
    t0 = time.perf_counter()
    with selk_capture(keep_inputs=True) as selk_calls, mlp_capture(every=frame_mlp) as mlp_calls, \
            overflow_capture() as direct_drops:
        out = renderer(**data, key=key)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    direct_launches, direct_variants = read_counts()
    check_counts(f"{frame} (direct)", direct_launches, direct_variants,
                 idle=("tex_fetch",), want=F32_FRAME_VARIANTS)
    color, alpha = out["color_pred"][0].cpu().numpy(), out["alpha_pred"][0].cpu().numpy()
    direct = decode_png_u8(encode_png(straight_rgba(color, alpha, h, w))).astype(np.int32)
    u8_diff = int(np.abs(direct - images[0]).max())
    u8_share = float(np.mean(direct != images[0]))
    with mlp_wrap(lambda real, *args: real.mlp_fused_plain(*args)):
        plain = renderer(**data, key=key)
    plain_diff = max(float((out[k] - plain[k]).abs().max()) for k in ("color_pred",
                                                                        "alpha_pred"))
    log(f"{frame}: first PNG vs the direct render under stream_key(STREAM_PERTURB, 0): "
        f"max {u8_diff} u8 levels (limit {MAIN_U8_MAX_DIFF}), {u8_share:.2e} of values differ; "
        f"direct render {direct_s:.2f} s (launches {direct_launches}, dropped (hits, samples) "
        f"{direct_drops}), max |kernel - plain MLP| {plain_diff:.3g} (limit "
        f"{MAIN_PLAIN_MAX_DIFF}), alpha mean {float(alpha.mean()):.4f}")
    if not u8_diff <= MAIN_U8_MAX_DIFF:
        raise AssertionError(f"nerftex_torch.main's first image differs from the direct "
                             f"render by {u8_diff} u8 levels")
    if not plain_diff <= MAIN_PLAIN_MAX_DIFF:
        raise AssertionError(f"the {frame} frame through the kernel differs from the "
                             f"plain MLP's by {plain_diff}")
    if want_drops is not None and (main_drops != want_drops
                                   or direct_drops != want_drops[:1]):
        raise AssertionError(f"the {frame} frames dropped (hits, samples) main {main_drops}, "
                             f"direct {direct_drops}; the JAX package drops {want_drops}")
    packed = mlp_calls[0][2]
    if (packed.pos_dim, packed.dir_dim) != maps:
        raise AssertionError(f"{frame} maps {packed.pos_dim}/{packed.dir_dim} wide, not {maps}")
    rows = {
        "mlp_fused": mlp_kernel_row(fused, packed, [mlp_row(
            fused, packed, *mlp_calls[0][:2], "float32",
            f"the {frame} frame's first net_chunk")]),
        "selk_resolve": dict(check_selk_frame(selk, selk_calls, frame),
                             **selk_frame_record(selk_calls, direct_launches["selk_resolve"],
                                                 frame)),
    }
    numbers = {"frames": MAIN_FRAMES, "main_s": main_s, "rays_per_s": MAIN_FRAMES * h * w / main_s,
               "peak_gib": peak, "direct_render_s": direct_s, "first_vs_direct_max_u8": u8_diff,
               "first_vs_direct_share": u8_share, "plain_max_abs_diff": plain_diff,
               "main_drops": main_drops, "direct_drops": direct_drops}
    if frame_mlp:
        if len(mlp_calls) != direct_launches["mlp_fused"]:
            raise AssertionError(f"{frame}: {len(mlp_calls)} mlp_fused calls captured, "
                                 f"{direct_launches['mlp_fused']} launched")
        chain = cublas_chain(packed, torch.float32)
        totals = {
            "frame_samples": sum(c[0].shape[0] for c in mlp_calls),
            "frame_device_ms": device_ms(lambda: [fused.mlp_fused(*c) for c in mlp_calls],
                                         iters=1),
            "frame_cublas_device_ms": device_ms(lambda: [chain(*cublas_inputs(
                c[2], c[0], c[1], torch.float32)) for c in mlp_calls], iters=1),
            "frame_bound_ms": sum(mlp_bounds(c[2], c[0].shape[0], "float32")[0]
                                  for c in mlp_calls),
        }
        log(f"{frame} direct render's MLP over its {len(mlp_calls)} launches "
            f"({totals['frame_samples']} samples): kernel device {totals['frame_device_ms']:.3f} "
            f"ms, cuBLAS f32 chain {totals['frame_cublas_device_ms']:.3f} ms, bound "
            f"{totals['frame_bound_ms']:.3f} ms on {card}")
        rows["mlp_fused"].update(totals)
        del chain
    for row in rows.values():
        row["direct_render_launches"] = direct_launches[row["name"]]
    selk_calls.clear()
    mlp_calls.clear()
    del renderer, model, out, plain
    torch.cuda.empty_cache()
    return numbers, rows, launches


def serve_grass(params, h, w, reset_counts, read_counts, check_counts, card, frame_psnr_db):
    """Serve SERVE_REQUESTS through RenderSession(config_grass_render,
    operating_point="grass") on the card from a checkpoint of the grass
    weights in the JAX package's pickle layout, written to a temporary
    target_path.  The first response must equal (SERVE_MAX_DIFF) a direct
    render of the session's rays for that request under
    rng.stream_key(STREAM_PERTURB, 0), after the same alpha division.
    Then a second session, with the golden's bf16 dots (bf16_dots), renders
    the first request's rays under key(1), the grass frame's draws: its
    PSNR against the golden beside the grass frame's (frame_psnr_db) tells
    the session's path from its dots and draws.  Returns the latencies and
    PSNRs, and the kernels' launch counts over the four requests."""
    import tempfile

    from configs.config_grass_render import config
    from nerftex_torch.render.checkpoint import CheckpointManager, unflatten_params
    from nerftex_torch.render.serve import RenderSession, straight_rgba
    from nerftex_torch.utils import jax_rng, rng

    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_serve_") as target:
        CheckpointManager(os.path.join(target, "checkpoints")).save(
            {"models": {"model": unflatten_params(params)}, "extra": {"step": 1}}, 1)
        t0 = time.perf_counter()
        session = RenderSession(dict(config, target_path=target), operating_point="grass",
                                device="cuda")
        build_s = time.perf_counter() - t0
        if not session.restored_from.endswith("ckpt-1.pkl"):
            raise AssertionError(f"the session restored {session.restored_from}")
        reset_counts()
        images, latencies = [], []
        for pos, prm in SERVE_REQUESTS:
            t0 = time.perf_counter()
            images.append(session.render(pos, parameters=prm))
            latencies.append((time.perf_counter() - t0) * 1e3)
        launches, variants = read_counts()
        log(f"serving (4 requests): launches {launches}, variants {variants}")
        check_counts("grass serving", launches, variants, idle=("tex_fetch",), shadows=True)
        for img in images:
            if img.shape != (h, w, 4) or not np.isfinite(img).all():
                raise AssertionError(f"served frame {img.shape} is not a finite {h}x{w} RGBA")
        if np.abs(images[3] - images[0]).max() < 1e-3:
            raise AssertionError("moving the light changed nothing in the served frame")

        rays_o, rays_d, t, cone = session.device_rays(session.pose(SERVE_REQUESTS[0][0]))
        out = session.renderer(rays_o=rays_o[None], rays_d=rays_d[None], t=t[None],
                               parameters=session.default_parameters[None],
                               cone_scale=cone[None],
                               key=rng.stream_key(rng.STREAM_PERTURB, 0))
        color, alpha = out["color_pred"][0].cpu().numpy(), out["alpha_pred"][0].cpu().numpy()
        diff = float(np.abs(straight_rgba(color, alpha, h, w) - images[0]).max())
        log(f"serving: first response vs direct render under stream_key(STREAM_PERTURB, 0): max "
            f"|diff| {diff:.3g} (limit {SERVE_MAX_DIFF})")
        if not diff <= SERVE_MAX_DIFF:
            raise AssertionError(f"the first served frame differs from the direct render: {diff}")
        psnr = scene_golden_psnr("grass", color, alpha, h, w)
        log(f"serving: session build {build_s:.2f} s; latency per request "
            f"{', '.join(f'{ms:.1f}' for ms in latencies)} ms (first, then warm) -> "
            f"{', '.join(f'{h * w / ms * 1e3:.1f}' for ms in latencies)} rays/s; first response "
            f"{psnr:.2f} dB against the grass golden (information only: float32 dots and the "
            f"session's own draws) on {card}")
        del session, out
        torch.cuda.empty_cache()

        session = RenderSession(bf16_dots(dict(config, target_path=target)),
                                operating_point="grass", device="cuda")
        rays_o, rays_d, t, cone = session.device_rays(session.pose(SERVE_REQUESTS[0][0]))
        out = session.renderer(rays_o=rays_o[None], rays_d=rays_d[None], t=t[None],
                               parameters=session.default_parameters[None],
                               cone_scale=cone[None], key=jax_rng.key(1))
        psnr_key1 = scene_golden_psnr("grass", out["color_pred"][0].cpu().numpy(),
                                      out["alpha_pred"][0].cpu().numpy(), h, w)
        log(f"serving: the first request through a session with bf16 dots under key(1): "
            f"{psnr_key1:.2f} dB against the grass golden (the grass frame: "
            f"{frame_psnr_db:.2f} dB)")
        del session, out
        torch.cuda.empty_cache()
    return ({"latency_ms": latencies, "rays_per_s": [h * w / ms * 1e3 for ms in latencies],
             "session_build_s": build_s, "first_vs_direct_max_diff": diff,
             "first_golden_psnr_db": psnr, "bf16_key1_golden_psnr_db": psnr_key1}, launches)


def train_fixture_step(card):
    """configs/config_carpet_train.py's model at full width (the JAX init in
    tests/torch_train_inputs.npz), renderer, loss and Adam schedule on the
    card, over the fixture's three JAX batches under
    fold_in(stream_key(STREAM_PERTURB), s): step 0's loss and every leaf's
    gradient, and the losses of steps 1 and 2 (after the Adam updates),
    against the JAX package's on the CPU."""
    import importlib

    from nerftex_torch.render.checkpoint import as_jax_tree, flatten_params, load_jax_params
    from nerftex_torch.render.train import make_optimizer, make_train_step
    from nerftex_torch.utils import jax_rng, rng
    from nerftex_torch.utils.util import instantiate

    config = importlib.import_module("configs.config_carpet_train").config
    inputs = np.load(os.path.join(ROOT, "tests", "torch_train_inputs.npz"))
    want_losses = inputs["loss"]
    rng.set_seed(config["seed"])
    model = instantiate(dict(config["model_config"], n_parameters=[1, 6]), device="cuda")
    load_jax_params(model, npz_params("torch_train_inputs.npz"))
    renderer = instantiate(dict(config["renderer_config"], model=model, device="cuda"))
    optimizer = make_optimizer(model.parameters(), config["lrate"], config["lrate_decay"])
    step = make_train_step(renderer, instantiate(config["loss_config"]), optimizer, False,
                           [1, 1, 1.0])
    base = rng.stream_key(rng.STREAM_PERTURB)
    torch.cuda.reset_peak_memory_stats()
    losses, grad_err, grad64_err = [], {}, {}
    for s in range(len(want_losses)):
        batch = {k[len(f"batch{s}/"):]: torch.tensor(inputs[k], device="cuda")
                 for k in inputs.files if k.startswith(f"batch{s}/")}
        losses.append(float(step(batch, jax_rng.fold_in(base, s))))
        if s == 0:
            # The gradients of step 0 stay in .grad until the next step.
            grads = flatten_params(as_jax_tree(model, lambda p: p.grad.cpu().numpy()))
            for leaf, g in grads.items():
                for errs, name in ((grad_err, "grad"), (grad64_err, "grad64")):
                    want = inputs[f"{name}/{leaf}"]
                    errs[leaf] = float(np.abs(g - want).max() / np.abs(want).max())
    peak = torch.cuda.max_memory_allocated() / 2**30
    rel = [abs(a - float(b)) / abs(float(b)) for a, b in zip(losses, want_losses)]
    worst_leaf = max(grad_err, key=grad_err.get)
    worst64 = max(grad64_err, key=grad64_err.get)
    log(f"training step at full width vs JAX ({len(losses)} steps, 4 x 256 rays x 256 samples): "
        f"losses {losses} vs JAX {[float(v) for v in want_losses]}, relative {rel} (limits "
        f"{TRAIN_STEP_LOSS_RTOL}, then {TRAIN_LATER_LOSS_RTOL}); step-0 gradient worst leaf "
        f"{worst_leaf} {grad_err[worst_leaf]:.3g} of its max |g| from JAX's, {worst64} "
        f"{grad64_err[worst64]:.3g} from JAX's with float64 dots (limit {TRAIN_GRAD_TOL}); "
        f"per leaf from the float64 dots' {json.dumps(grad64_err)}; peak device memory "
        f"{peak:.2f} GiB on {card}")
    if not rel[0] <= TRAIN_STEP_LOSS_RTOL:
        raise AssertionError(f"step 0's loss differs from JAX's by {rel[0]} relative")
    if not max(rel[1:]) <= TRAIN_LATER_LOSS_RTOL:
        raise AssertionError(f"the losses after Adam updates differ from JAX's by {rel[1:]}")
    if not grad_err[worst_leaf] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"step 0's gradient of {worst_leaf} differs from JAX's by "
                             f"{grad_err[worst_leaf]} of its max |g|")
    if not grad64_err[worst64] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"step 0's gradient of {worst64} differs from JAX's with float64 "
                             f"dots by {grad64_err[worst64]} of its max |g|")
    del model, renderer, optimizer, step
    torch.cuda.empty_cache()
    return {"losses": losses, "jax_losses": [float(v) for v in want_losses], "loss_rel": rel,
            "grad_rel_worst": grad_err[worst_leaf], "grad_rel_worst_leaf": worst_leaf,
            "grad64_rel_worst": grad64_err[worst64], "grad64_rel_worst_leaf": worst64,
            "peak_gib": peak}


def write_train_config(directory, name, stock, tfr, overrides, logger):
    """A config module ``<name>.py`` in ``directory`` (under the repo, so
    main imports it by its relative path) that deep-copies the shipped
    configs/<stock>.py and sets the TFRecord, the target path and
    ``overrides`` (top level) and ``logger`` (logger_config); returns
    (path to pass to main, target_path)."""
    target = os.path.join(directory, name + "_logs")
    with open(os.path.join(directory, name + ".py"), "w") as f:
        f.write("import copy\n\n"
                f"from configs.{stock} import config as _stock\n\n"
                "config = copy.deepcopy(_stock)\n"
                f"config.update(target_path={target!r}, **{overrides!r})\n"
                f"config['train_dataset_config']['data_loader_config']['tfr_path'] = {tfr!r}\n"
                f"config['logger_config'].update({logger!r})\n")
    return os.path.join(os.path.relpath(directory, ROOT), name + ".py"), target


@contextlib.contextmanager
def logger_timing(sync_steps):
    """While active, the training Logger's calls of the steps in
    ``sync_steps`` record the time after a device sync (the other steps
    run as they do without it), and its checkpoint saves and validation
    renders their durations, in the dict it yields."""
    from nerftex_torch.render import logger as logger_mod

    cls = logger_mod.Logger
    real = {name: getattr(cls, name) for name in ("__call__", "save_checkpoint",
                                                   "render_images")}
    record = {"steps": {}, "save_checkpoint": [], "render_images": []}

    def timed(name):
        def wrapper(self, *args, **kwargs):
            t0 = time.perf_counter()
            out = real[name](self, *args, **kwargs)
            torch.cuda.synchronize()
            record[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    def call(self, loss):
        out = real["__call__"](self, loss)
        if self.step in sync_steps:
            torch.cuda.synchronize()
            record["steps"][self.step] = time.perf_counter()
        return out

    cls.__call__, cls.save_checkpoint, cls.render_images = (call, timed("save_checkpoint"),
                                                            timed("render_images"))
    try:
        yield record
    finally:
        for name, fn in real.items():
            setattr(cls, name, fn)


def steps_per_s(record, first, last, n_saves_inside):
    """Training steps per second between the logger calls of steps
    ``first`` and ``last`` (each timed after a device sync), without the
    checkpoint saves made between them."""
    saves = sum(record["save_checkpoint"][:n_saves_inside])
    return (last - first) / (record["steps"][last] - record["steps"][first] - saves)


@contextlib.contextmanager
def mlp_event_timing():
    """While active, every mlp_fused call of the render path is bracketed
    by CUDA events; the list it yields gets each launch's (start, end)."""
    events = []

    def call(real, pos_map, dir_map, packed):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real.mlp_fused(pos_map, dir_map, packed)
        end.record()
        events.append((start, end))
        return out

    with mlp_wrap(call):
        yield events


def check_validation_render(frame, config, target, n_steps, counts, dtype_name="float32",
                            plain_tol=TRAIN_PLAIN_MAX_DIFF, maps=None):
    """A train config's validation render, once nerftex_torch.main has
    trained it for ``n_steps`` into ``target``: the last checkpoint restores
    bit for bit into a fresh model, which renders the first validation
    image again (the Logger's first keyless render draws
    stream_key(STREAM_PERTURB, 0)) through the kernel (every launch
    wgmma_tf32x3, or wgmma_bf16 for a bf16 model), within MAIN_U8_MAX_DIFF
    of the PNG main wrote and within ``plain_tol`` of the same render
    through the plain MLP; the kernel against its plain version at that
    render's first net_chunk; the validation renders' mlp_fused launches
    timed by events; with ``maps``, the packed (pos, dir) widths.  Returns
    (numbers, {"mlp_fused": kernels-line row})."""
    from nerftex_torch.kernels import mlp_fused as fused
    from nerftex_torch.render.checkpoint import (CheckpointManager, export_jax_params,
                                                 flatten_params, load_jax_params)
    from nerftex_torch.render.serve import straight_rgba
    from nerftex_torch.utils import rng
    from nerftex_torch.utils.image import decode_png_u8, encode_png
    from nerftex_torch.utils.util import instantiate

    reset_counts, read_counts, check_counts = counts
    saved = CheckpointManager(os.path.join(target, "checkpoints")).restore_latest()
    rng.set_seed(config["seed"])
    model = instantiate(dict(config["model_config"]), device="cuda")
    load_jax_params(model, saved["models"]["model"])
    restored = flatten_params(export_jax_params(model))
    stored = flatten_params(saved["models"]["model"])
    if set(restored) != set(stored) or any(not np.array_equal(restored[k], stored[k])
                                           for k in stored):
        raise AssertionError(f"{frame}: the last checkpoint does not restore bit for bit")
    renderer = instantiate(dict(config["renderer_config"], model=model, device="cuda"))
    items = list(instantiate(config["val_dataset_config"]))
    val = instantiate(config["val_dataset_config"])
    key = rng.stream_key(rng.STREAM_PERTURB, 0)
    reset_counts()
    with mlp_capture() as mlp_calls:
        out = renderer(**items[0], training=False, key=key)
    torch.cuda.synchronize()
    direct_launches, direct_variants = read_counts()
    check_counts(f"{frame} (direct)", direct_launches, direct_variants,
                 idle=("tex_fetch", "selk_resolve", "per_ray"),
                 want=F32_FRAME_VARIANTS if dtype_name == "float32" else FRAME_VARIANTS)
    with mlp_wrap(lambda real, *args: real.mlp_fused_plain(*args)):
        plain = renderer(**items[0], training=False, key=key)
    plain_diff = max(float((out[k] - plain[k]).abs().max()) for k in ("color_pred",
                                                                        "alpha_pred"))
    h, w = val.height, val.width
    color, alpha = out["color_pred"][0].cpu().numpy(), out["alpha_pred"][0].cpu().numpy()
    direct = decode_png_u8(encode_png(straight_rgba(color, alpha, h, w))).astype(np.int32)
    with open(os.path.join(target, "media", "validation", str(n_steps), "0.png"), "rb") as f:
        written = decode_png_u8(f.read()).astype(np.int32)
    u8_diff = int(np.abs(direct - written).max())
    # The validation renders' MLP launches, each timed by events.
    with mlp_event_timing() as events:
        for item in items:
            renderer(**item, training=False)
    torch.cuda.synchronize()
    val_mlp_ms = sum(a.elapsed_time(b) for a, b in events)
    log(f"{frame} validation render: restored checkpoint bit-equal; max |kernel - plain MLP| "
        f"{plain_diff:.3g} (limit {plain_tol}); the first PNG vs the direct render "
        f"{u8_diff} u8 levels; alpha mean {float(alpha.mean()):.4f}; mlp_fused over all "
        f"{len(items)} validation renders ({len(events)} launches) {val_mlp_ms:.2f} ms of device "
        f"time")
    if not plain_diff <= plain_tol:
        raise AssertionError(f"{frame}: the validation render through the kernel differs from "
                             f"the plain MLP's by {plain_diff}")
    if not u8_diff <= MAIN_U8_MAX_DIFF:
        raise AssertionError(f"{frame}: the first validation PNG differs from the restored "
                             f"model's render by {u8_diff} u8 levels")
    pos_map, dir_map, packed = mlp_calls[0]
    if maps is not None and (packed.pos_dim, packed.dir_dim) != maps:
        raise AssertionError(f"{frame} maps {packed.pos_dim}/{packed.dir_dim} wide, not {maps}")
    row = mlp_kernel_row(fused, packed, [mlp_row(
        fused, packed, pos_map, dir_map, dtype_name,
        f"the {frame} validation render's first net_chunk")])
    row.update(validation_launches=len(events), validation_device_ms=val_mlp_ms,
               validation_bound_ms=len(events) * mlp_bounds(packed, pos_map.shape[0],
                                                            dtype_name)[0])
    numbers = {"plain_max_abs_diff": plain_diff, "first_png_vs_direct_u8": u8_diff,
               "validation_mlp_device_ms": val_mlp_ms, "validation_mlp_launches": len(events)}
    del model, renderer, out, plain, mlp_calls
    torch.cuda.empty_cache()
    return numbers, {"mlp_fused": row}


def main_training(counts, card):
    """The training phase (see the module docstring): the full-width step
    against JAX, then ``nerftex_torch.main`` on the carpet train config for
    TRAIN_STEPS steps and on the grass_filtered train config for
    GRASS_FILTERED_TRAIN_STEPS steps, each on a synthetic TFRecord written
    by nerftex_torch.tools.synth.  Returns (numbers, kernel rows, main's
    launch counts) per config."""
    import importlib
    import tempfile

    from nerftex_torch import main as port_main
    from nerftex_torch.models import mlp
    from nerftex_torch.tools.synth import make_synthetic_tfrecord

    reset_counts, read_counts, check_counts = counts
    numbers, rows, launches = {}, {}, {}
    t0 = time.perf_counter()
    numbers["carpet_train_step_vs_jax"] = train_fixture_step(card)
    log(f"training: full-width step vs JAX {time.perf_counter() - t0:.1f} s")

    os.environ["NERFTEX_NO_TENSORBOARD"] = "1"
    config = importlib.import_module("configs.config_carpet_train").config
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_train_") as work:
        # -- the user's command on the carpet train config ----------------------
        t0 = time.perf_counter()
        proxy = config["train_dataset_config"]["proxy_config"]
        tfr = make_synthetic_tfrecord(os.path.join(work, "carpet.tfr"), **TRAIN_SYNTH,
                                      n_parameters=tuple(config["model_config"]["n_parameters"]),
                                      b_0=tuple(proxy["b_0"]), b_1=tuple(proxy["b_1"]))
        synth_s = time.perf_counter() - t0
        cfg_path, target = write_train_config(
            work, "carpet_train", "config_carpet_train", tfr, {"n_iters": TRAIN_STEPS},
            {"i_img": TRAIN_STEPS, "i_checkpoint": TRAIN_CHECKPOINT_EVERY})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        # The models built so far in this process advanced the init counter;
        # a user's fresh process starts it at 0 (the JAX factories' keys).
        mlp._INIT_COUNTER[0] = 0
        t0 = time.perf_counter()
        with logger_timing((10, TRAIN_STEPS - 10)) as record:
            port_main.main([cfg_path])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        carpet_launches, variants = read_counts()
        rate = steps_per_s(record, 10, TRAIN_STEPS - 10,
                           TRAIN_STEPS // TRAIN_CHECKPOINT_EVERY - 1)
        log(f"nerftex_torch.main {cfg_path} ({TRAIN_STEPS} steps, synthetic TFRecord of "
            f"{TRAIN_SYNTH['n_images']} x {TRAIN_SYNTH['size']}^2 written in {synth_s:.1f} s): "
            f"{main_s:.1f} s; {rate:.2f} steps/s over steps 10-{TRAIN_STEPS - 10} (validation "
            f"renders and saves excluded); validation renders {record['render_images']} s, saves "
            f"{record['save_checkpoint']} s; peak device memory {peak:.2f} GiB; launches "
            f"{carpet_launches}, variants {variants} on {card}")
        # The only kernel of training is the validation renders' MLP.
        check_counts("carpet_train (main)", carpet_launches, variants,
                     idle=("tex_fetch", "selk_resolve", "per_ray"), want=F32_FRAME_VARIANTS)
        if not carpet_launches["mlp_fused"] > 1:
            raise AssertionError(f"the validation renders launched mlp_fused "
                                 f"{carpet_launches['mlp_fused']} times")
        with open(os.path.join(target, "scalars.jsonl")) as f:
            scalars = [json.loads(line) for line in f]
        losses = [r["Loss"] for r in scalars]
        n_summaries = TRAIN_STEPS // 10
        if len(losses) != n_summaries or not np.isfinite(losses).all():
            raise AssertionError(f"{len(losses)} scalars, not {n_summaries}: {losses}")
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"carpet_train losses (every 10th step): {losses}; mean of the last five {last5:.5f} "
            f"vs the first five {first5:.5f}")
        if not last5 < 0.9 * first5:
            raise AssertionError(f"the loss did not fall: {first5} -> {last5}")
        ckpts = sorted(os.listdir(os.path.join(target, "checkpoints")))
        want_ckpts = sorted(f"ckpt-{s}.pkl" for s in range(
            TRAIN_CHECKPOINT_EVERY, TRAIN_STEPS + 1, TRAIN_CHECKPOINT_EVERY))
        if ckpts != want_ckpts:
            raise AssertionError(f"checkpoints {ckpts}, not {want_ckpts}")
        media = os.path.join(target, "media", "validation", str(TRAIN_STEPS))
        names = sorted(os.listdir(media))
        if names != ["0.png", "1.png"]:
            raise AssertionError(f"validation images {names}")

        val, rows["carpet_train"] = check_validation_render(
            "carpet_train", config, target, TRAIN_STEPS, counts)
        launches["carpet_train"] = carpet_launches
        numbers["carpet_train"] = {
            "steps": TRAIN_STEPS, "steps_per_s": rate, "main_s": main_s, "peak_gib": peak,
            "loss_first5": first5, "loss_last5": last5, "checkpoints": ckpts,
            "validation_render_s": record["render_images"],
            "checkpoint_save_s": record["save_checkpoint"], **val}

        # -- grass_filtered: raw_noise_std and blur_idx ------------------------------
        gf = importlib.import_module("configs.config_grass_filtered_train").config
        proxy = gf["train_dataset_config"]["proxy_config"]
        tfr = make_synthetic_tfrecord(os.path.join(work, "grass_filtered.tfr"), **TRAIN_SYNTH,
                                      n_parameters=tuple(gf["model_config"]["n_parameters"]),
                                      b_0=tuple(proxy["b_0"]), b_1=tuple(proxy["b_1"]))
        n = GRASS_FILTERED_TRAIN_STEPS
        cfg_path, target = write_train_config(
            work, "grass_filtered_train", "config_grass_filtered_train", tfr, {"n_iters": n},
            {"i_summary": 1, "i_img": n, "i_checkpoint": n})
        reset_counts()
        mlp._INIT_COUNTER[0] = 0
        t0 = time.perf_counter()
        with logger_timing((2, n - 1)) as record:
            port_main.main([cfg_path])
        torch.cuda.synchronize()
        gf_s = time.perf_counter() - t0
        gf_launches, gf_variants = read_counts()
        with open(os.path.join(target, "scalars.jsonl")) as f:
            gf_losses = [json.loads(line)["Loss"] for line in f]
        gf_rate = steps_per_s(record, 2, n - 1, 0)
        log(f"nerftex_torch.main {cfg_path} (raw_noise_std 0.1, blur_idx 0; {n} steps): "
            f"{gf_s:.1f} s, {gf_rate:.2f} steps/s; losses {gf_losses}; launches {gf_launches}, "
            f"variants {gf_variants}")
        if len(gf_losses) != n or not np.isfinite(gf_losses).all():
            raise AssertionError(f"grass_filtered_train losses {gf_losses}")
        check_counts("grass_filtered_train (main)", gf_launches, gf_variants,
                     idle=("tex_fetch", "selk_resolve", "per_ray"), want=F32_FRAME_VARIANTS)
        if not gf_launches["mlp_fused"] > 1:
            raise AssertionError(f"the validation renders launched mlp_fused "
                                 f"{gf_launches['mlp_fused']} times")
        val, rows["grass_filtered_train"] = check_validation_render(
            "grass_filtered_train", gf, target, n, counts)
        launches["grass_filtered_train"] = gf_launches
        numbers["grass_filtered_train"] = {"steps": n, "steps_per_s": gf_rate, "main_s": gf_s,
                                           "losses": gf_losses, **val}
    return numbers, rows, launches


def _synth_view(args):
    """One 512x512 synthetic view (nerftex_torch.tools.synth, seed ``seed``)
    written as a one-record TFRecord at ``path``; returns the file's bytes
    (a framed record).  Runs in a worker process."""
    path, seed, n_parameters, b_0, b_1 = args
    from nerftex_torch.tools.synth import make_synthetic_tfrecord

    make_synthetic_tfrecord(path, n_images=1, size=512, seed=seed, n_parameters=n_parameters,
                            b_0=b_0, b_1=b_1)
    with open(path, "rb") as f:
        return f.read()


def cycled_tfrecords(work, config, n_views, sizes):
    """n_views distinct 512x512 synthetic views for the config's proxy box
    and parameter count, rendered in parallel processes (seeds 0 ..
    n_views - 1), and for each n in ``sizes`` a TFRecord of n records
    cycling them (each record keeps its view's pose and parameters).
    Returns ({n: path}, synth seconds)."""
    import concurrent.futures
    import multiprocessing

    proxy = config["train_dataset_config"]["proxy_config"]
    n_parameters = tuple(config["model_config"]["n_parameters"])
    jobs = [(os.path.join(work, f"view{v}.tfr"), v, n_parameters, tuple(proxy["b_0"]),
             tuple(proxy["b_1"])) for v in range(n_views)]
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            n_views, mp_context=multiprocessing.get_context("spawn")) as pool:
        framed = list(pool.map(_synth_view, jobs))
    synth_s = time.perf_counter() - t0
    paths = {}
    for n in sizes:
        paths[n] = os.path.join(work, f"cycled{n}.tfr")
        with open(paths[n], "wb") as f:
            for i in range(n):
                f.write(framed[i % n_views])
    return paths, synth_s


def check_device_sampler(config, tfr):
    """The device-resident sampler built from ``tfr`` on the card and on
    the CPU: the same keys (made on each side, and one derived on the card
    from a step tensor as the training step derives it) give equal img_idx
    and loc and the batch within SAMPLER_TOLS."""
    from nerftex_torch.utils import jax_rng
    from nerftex_torch.utils.util import instantiate

    cfg = copy.deepcopy(config["train_dataset_config"])
    cfg["data_loader_config"]["tfr_path"] = tfr
    samplers = {dev: instantiate(cfg, device=dev).device_sampler for dev in ("cuda", "cpu")}
    worst = dict.fromkeys(SAMPLER_TOLS, 0.0)
    for seed in (0, 1):
        step = torch.tensor(7 + seed, device="cuda")
        keys = {"cuda": jax_rng.fold_in(jax_rng.key(seed).cuda(), step),
                "cpu": jax_rng.fold_in(jax_rng.key(seed), 7 + seed)}
        out = {dev: samplers[dev].sample(keys[dev], with_aux=True) for dev in samplers}
        (gb, gaux), (cb, caux) = out["cuda"], out["cpu"]
        for name in ("img_idx", "loc"):
            if not torch.equal(gaux[name].cpu(), caux[name]):
                raise AssertionError(f"device sampler: {name} differs between the card and the "
                                     f"CPU for key {seed}")
        for name in SAMPLER_TOLS:
            worst[name] = max(worst[name], float((gb[name].cpu() - cb[name]).abs().max()))
    log(f"device sampler on the card vs the CPU ({samplers['cpu'].n_images} views of "
        f"{samplers['cpu'].height}^2, {cfg['batchsize']} x {samplers['cpu'].n_samples} rays): "
        f"img_idx and loc equal; max abs diff {worst} (limits {SAMPLER_TOLS})")
    bad = {k: v for k, v in worst.items() if not v <= SAMPLER_TOLS[k]}
    if bad:
        raise AssertionError(f"device sampler: the card and the CPU differ by {bad}")
    return worst


def check_graph_vs_eager(config, tfr):
    """DEVICE_TRAIN_GRAPH_STEPS graph-replayed steps (FusedStep.run) against
    as many eager steps of the same step function on the card, from the
    same state (the config's model, renderer and Adam at full width, JAX
    init, on ``tfr``'s dataset): losses and parameters."""
    from nerftex_torch.models import mlp
    from nerftex_torch.render import train as train_mod
    from nerftex_torch.utils import rng

    rng.set_seed(config["seed"])
    mlp._INIT_COUNTER[0] = 0
    cfg = copy.deepcopy(config)
    cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
    k = DEVICE_TRAIN_GRAPH_STEPS
    _, _, _, step = train_mod.build_step(
        cfg["train_dataset_config"], cfg["model_config"], cfg["loss_config"], cfg["lrate"],
        cfg["lrate_decay"], cfg["renderer_config"], "cuda", train_mod.TrainState(),
        flat_params=cfg.get("flat_params", False), steps_per_dispatch=k)
    step._init_adam_state()
    tensors = step._state_tensors()
    start = [t.detach().clone() for t in tensors]
    step.step.fill_(0)
    step.slot.zero_()
    for _ in range(k):
        step._body()
    eager_losses = step.losses[:k].cpu()
    eager = [p.detach().clone() for p in step._params()]
    with torch.no_grad():
        for t, v in zip(tensors, start):
            t.copy_(v)
    graph_losses = step.run(0, k)
    loss_rel = float(((graph_losses - eager_losses).abs() / eager_losses.abs()).max())
    params = [p.detach() for p in step._params()]
    param_diff = max(float((p - e).abs().max()) for p, e in zip(params, eager))
    equal = sum(int((p == e).sum()) for p, e in zip(params, eager))
    total = sum(p.numel() for p in eager)
    log(f"device-resident step, {k} graph replays vs {k} eager steps from the same state: "
        f"losses {graph_losses.tolist()} vs {eager_losses.tolist()} (max relative diff "
        f"{loss_rel:.3g}, limit {GRAPH_LOSS_RTOL}); parameters max abs diff {param_diff:.3g} "
        f"(limit {GRAPH_PARAM_TOL}), {equal} of {total} bit-equal")
    if not loss_rel <= GRAPH_LOSS_RTOL:
        raise AssertionError(f"graph replays' losses differ from the eager steps' by {loss_rel}")
    if not param_diff <= GRAPH_PARAM_TOL:
        raise AssertionError(f"graph replays' parameters differ from the eager steps' by "
                             f"{param_diff}")
    del step
    torch.cuda.empty_cache()
    return {"loss_rel": loss_rel, "param_max_abs_diff": param_diff, "params_bit_equal": equal,
            "params": total}


def compare_host_fed(config, tfr, fused, start, card):
    """Steps/s of the config host-fed (device_resident off, one step per
    dispatch, the same bf16 model and renderer, ``tfr``'s records through
    the prefetch thread; HOST_FED_COMPARE_STEPS steps) against the
    device-resident ``fused`` step (the one main trained, continuing from
    ``start``; DEVICE_COMPARE_STEPS steps), interleaved P C C P."""
    from nerftex_torch.models import mlp
    from nerftex_torch.render import train as train_mod
    from nerftex_torch.utils import jax_rng, rng

    rng.set_seed(config["seed"])
    mlp._INIT_COUNTER[0] = 0
    cfg = copy.deepcopy(config)
    cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
    cfg["train_dataset_config"]["device_resident"] = False
    state = train_mod.TrainState()
    dataset, _, _, host_step = train_mod.build_step(
        cfg["train_dataset_config"], cfg["model_config"], cfg["loss_config"], cfg["lrate"],
        cfg["lrate_decay"], cfg["renderer_config"], "cuda", state)
    n_host, n_dev = HOST_FED_COMPARE_STEPS, DEVICE_COMPARE_STEPS
    warm = 5
    batches = iter(dataset.take(2 * n_host + warm))
    base = rng.stream_key(rng.STREAM_PERTURB)
    s = 0

    def host_steps(count):
        nonlocal s
        for _ in range(count):
            data = next(batches)
            batch = {k: torch.as_tensor(v).to("cuda", non_blocking=True)
                     for k, v in data.items()}
            host_step(batch, jax_rng.fold_in(base, s))
            s += 1
            state.step = s

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    host_steps(warm)
    rates = {"host_fed": [], "device_resident": []}
    k = fused.losses.shape[0]
    for side in ("host_fed", "device_resident", "device_resident", "host_fed"):
        if side == "host_fed":
            rates[side].append(timed(lambda: host_steps(n_host), n_host))
        else:
            rates[side].append(timed(lambda: [fused.run(start + i, k)
                                              for i in range(0, n_dev, k)], n_dev))
            start += n_dev
    log(f"steps/s interleaved P C C P (P: {n_host} host-fed steps, device_resident off, one "
        f"step per dispatch; C: {n_dev} steps of the device-resident step main trained, {k} "
        f"graph replays per dispatch): host-fed {rates['host_fed']}, device-resident "
        f"{rates['device_resident']} on {card}")
    return rates


def main_device_training(counts, card, keep_tfr):
    """The device-resident training phase (see the module docstring):
    configs/full_carpet_train_device.py through nerftex_torch.main on a
    DEVICE_TRAIN_RECORDS-record TFRecord of synthetic 512x512 views, with
    the sampler, graph-vs-eager, loss, validation and graph-use checks, and
    the host-fed comparison; the DEVICE_TRAIN_CHECK_VIEWS-record TFRecord
    is copied to ``keep_tfr`` for phase 15.  Returns (numbers, kernel rows,
    main's launch counts)."""
    import importlib
    import shutil
    import tempfile

    from nerftex_torch import main as port_main
    from nerftex_torch.data import device_dataset
    from nerftex_torch.models import mlp
    from nerftex_torch.render import train as train_mod

    reset_counts, read_counts, check_counts = counts
    os.environ["NERFTEX_NO_TENSORBOARD"] = "1"
    os.environ.pop("NERFTEX_BENCH_ITERS", None)
    config = importlib.import_module("configs.full_carpet_train_device").config
    numbers = {}
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_train_device_") as work:
        tfrs, synth_s = cycled_tfrecords(work, config, DEVICE_TRAIN_VIEWS,
                                         (DEVICE_TRAIN_CHECK_VIEWS, DEVICE_TRAIN_RECORDS))
        log(f"device-resident training data: {DEVICE_TRAIN_VIEWS} distinct 512x512 synthetic "
            f"views in {synth_s:.1f} s, cycled into {DEVICE_TRAIN_RECORDS} and "
            f"{DEVICE_TRAIN_CHECK_VIEWS} records")
        shutil.copy(tfrs[DEVICE_TRAIN_CHECK_VIEWS], keep_tfr)
        t0 = time.perf_counter()
        numbers["sampler_card_vs_cpu"] = check_device_sampler(
            config, tfrs[DEVICE_TRAIN_CHECK_VIEWS])
        numbers["graph_vs_eager"] = check_graph_vs_eager(config, tfrs[DEVICE_TRAIN_CHECK_VIEWS])
        log(f"device-resident checks: {time.perf_counter() - t0:.1f} s")

        # -- the user's command -------------------------------------------------------
        n = DEVICE_TRAIN_STEPS
        cfg_path, target = write_train_config(
            work, "carpet_train_device", "full_carpet_train_device", tfrs[DEVICE_TRAIN_RECORDS],
            {"n_iters": n}, {"i_img": n, "i_checkpoint": DEVICE_TRAIN_CHECKPOINT_EVERY})
        # Keep main's FusedStep (for the P C C P comparison) and time its
        # sampler's host decode of the records.
        fused_steps, decode_s = [], []
        real_init = train_mod.FusedStep.__init__
        real_decode = device_dataset.DeviceResidentSampler._decode_all

        def keep(self, *args, **kwargs):
            real_init(self, *args, **kwargs)
            fused_steps.append(self)

        def decode(self, *args, **kwargs):
            t = time.perf_counter()
            out = real_decode(self, *args, **kwargs)
            decode_s.append(time.perf_counter() - t)
            return out

        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        for name in train_mod.step_counts:
            train_mod.step_counts[name] = 0
        mlp._INIT_COUNTER[0] = 0
        train_mod.FusedStep.__init__ = keep
        device_dataset.DeviceResidentSampler._decode_all = decode
        t0 = time.perf_counter()
        try:
            with logger_timing(DEVICE_TRAIN_RATE_STEPS) as record:
                port_main.main([cfg_path])
        finally:
            train_mod.FusedStep.__init__ = real_init
            device_dataset.DeviceResidentSampler._decode_all = real_decode
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches, variants = read_counts()
        graph_counts = dict(train_mod.step_counts)
        first, last = DEVICE_TRAIN_RATE_STEPS
        rate = steps_per_s(record, first, last, 1)
        fused = fused_steps[0]
        table_gb = fused.sampler.images.numel() * fused.sampler.images.element_size() / 1e9
        log(f"nerftex_torch.main {cfg_path} ({n} steps, {DEVICE_TRAIN_RECORDS} records, u8 "
            f"table {tuple(fused.sampler.images.shape)} = {table_gb:.2f} GB on the card, its "
            f"PNGs decoded on the host in {decode_s[0]:.1f} s): "
            f"{main_s:.1f} s; {rate:.2f} steps/s over steps {first}-{last} (validation renders "
            f"and saves excluded), {fused.losses.shape[0] / rate:.3f} s per dispatch; validation "
            f"renders {record['render_images']} s, saves {record['save_checkpoint']} s; peak "
            f"device memory {peak:.2f} GiB; graph {graph_counts}; launches {launches}, variants "
            f"{variants} on {card}")
        if graph_counts["graph_replays"] != n or graph_counts["eager_steps"] != 0 \
                or graph_counts["captures"] != 1:
            raise AssertionError(f"the device-resident run took {graph_counts}, not {n} graph "
                                 f"replays of one capture and no eager step")
        check_counts("carpet_train_device (main)", launches, variants,
                     idle=("tex_fetch", "selk_resolve", "per_ray"), want=FRAME_VARIANTS)
        with open(os.path.join(target, "scalars.jsonl")) as f:
            losses = [json.loads(line)["Loss"] for line in f]
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"carpet_train_device losses (every 10th step): {losses}; mean of the last five "
            f"{last5:.5f} vs the first five {first5:.5f}")
        if len(losses) != n // 10 or not np.isfinite(losses).all():
            raise AssertionError(f"{len(losses)} scalars, not {n // 10}: {losses}")
        if not last5 < 0.9 * first5:
            raise AssertionError(f"the loss did not fall: {first5} -> {last5}")
        ckpts = sorted(os.listdir(os.path.join(target, "checkpoints")))
        want = sorted(f"ckpt-{s}.pkl" for s in range(DEVICE_TRAIN_CHECKPOINT_EVERY, n + 1,
                                                     DEVICE_TRAIN_CHECKPOINT_EVERY))
        if ckpts != want:
            raise AssertionError(f"checkpoints {ckpts}, not {want}")
        names = sorted(os.listdir(os.path.join(target, "media", "validation", str(n))))
        if names != ["0.png", "1.png"]:
            raise AssertionError(f"validation images {names}")

        numbers["host_vs_device_steps_per_s"] = compare_host_fed(
            config, tfrs[DEVICE_TRAIN_RECORDS], fused, n, card)
        del fused, fused_steps
        torch.cuda.empty_cache()
        val, rows = check_validation_render("carpet_train_device", config, target, n, counts,
                                            dtype_name="bfloat16",
                                            plain_tol=DEVICE_TRAIN_PLAIN_MAX_DIFF)
        numbers["carpet_train_device"] = {
            "steps": n, "records": DEVICE_TRAIN_RECORDS, "views": DEVICE_TRAIN_VIEWS,
            "synth_s": synth_s, "decode_s": decode_s[0], "table_gb": table_gb,
            "steps_per_s": rate,
            "s_per_dispatch": config["steps_per_dispatch"] / rate, "main_s": main_s,
            "peak_gib": peak, "graph": graph_counts, "loss_first5": first5, "loss_last5": last5,
            "checkpoints": ckpts, "validation_render_s": record["render_images"],
            "checkpoint_save_s": record["save_checkpoint"], **val}
    return numbers, {"carpet_train_device": rows}, {"carpet_train_device": launches}


def leaf_digests(model):
    """sha256 of each leaf's float32 bytes in the JAX layout, as
    scripts/make_torch_mip_inputs.py stores them: {"trunk/0/w": bytes}."""
    import hashlib

    from nerftex_torch.render.checkpoint import export_jax_params, flatten_params

    return {k: hashlib.sha256(np.ascontiguousarray(v, np.float32).tobytes()).digest()
            for k, v in flatten_params(export_jax_params(model)).items()}


def mip_init_model(config, inputs):
    """The config's ParamNerf on the card as a fresh process initialises it
    (seed and init counter reset); fails unless every leaf is the JAX
    factory's (the fixture's digests)."""
    from nerftex_torch.models import mlp
    from nerftex_torch.utils import rng
    from nerftex_torch.utils.util import instantiate

    rng.set_seed(config["seed"])
    mlp._INIT_COUNTER[0] = 0
    model = instantiate(config["model_config"], device="cuda")
    want = {k[len("digest/"):]: inputs[k].tobytes() for k in inputs.files
            if k.startswith("digest/")}
    got = leaf_digests(model)
    if set(got) != set(want) or any(got[k] != want[k] for k in want):
        raise AssertionError(f"the port's init is not the JAX factory's: leaves "
                             f"{sorted(k for k in want if got.get(k) != want[k])}")
    return model


def mip_fixture_steps(card):
    """configs/demo_grass_mip_train.py's and demo_grass_mip_imp_train.py's
    model (the JAX init, checked by digest), renderer, loss and Adam
    schedule at full width on the card, over the fixture's three JAX
    batches under fold_in(stream_key(STREAM_PERTURB), s): step 0's loss and
    gradient (every leaf; the importance run, the fixture's leaves) and the
    losses of steps 1 and 2 against the JAX package's, at the training
    phase's limits."""
    import importlib

    from nerftex_torch.render.checkpoint import as_jax_tree, flatten_params
    from nerftex_torch.render.train import make_optimizer, make_train_step
    from nerftex_torch.utils import jax_rng, rng
    from nerftex_torch.utils.util import instantiate

    inputs = np.load(os.path.join(ROOT, "tests", MIP_INPUTS))
    results = {}
    for name, stock, prefix in (("grass_mip", "demo_grass_mip_train", ""),
                                ("grass_mip_imp", "demo_grass_mip_imp_train", "imp/")):
        config = importlib.import_module(f"configs.{stock}").config
        want_losses = inputs[prefix + "loss"]
        model = mip_init_model(config, inputs)
        renderer = instantiate(dict(config["renderer_config"], model=model, device="cuda"))
        optimizer = make_optimizer(model.parameters(), config["lrate"], config["lrate_decay"])
        step = make_train_step(renderer, instantiate(config["loss_config"]), optimizer, False,
                               [1, 1, 1.0])
        base = rng.stream_key(rng.STREAM_PERTURB)
        torch.cuda.reset_peak_memory_stats()
        losses, grad_err = [], {}
        t0 = time.perf_counter()
        for s in range(len(want_losses)):
            batch = {k[len(f"batch{s}/"):]: torch.tensor(inputs[k], device="cuda")
                     for k in inputs.files if k.startswith(f"batch{s}/")}
            losses.append(float(step(batch, jax_rng.fold_in(base, s))))
            if s == 0:
                grads = flatten_params(as_jax_tree(model, lambda p: p.grad.cpu().numpy()))
                for leaf in (k[len(prefix + "grad/"):] for k in inputs.files
                             if k.startswith(prefix + "grad/")):
                    want = inputs[f"{prefix}grad/{leaf}"]
                    grad_err[leaf] = float(np.abs(grads[leaf] - want).max() / np.abs(want).max())
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        rel = [abs(a - float(b)) / abs(float(b)) for a, b in zip(losses, want_losses)]
        worst = max(grad_err, key=grad_err.get)
        log(f"{name} step at full width vs JAX ({len(losses)} steps, 4 x 256 rays x "
            f"{config['renderer_config']['n_samples']} segments"
            f"{', +%d importance posts' % config['renderer_config'].get('n_importance', 0)}): "
            f"losses {losses} vs JAX {[float(v) for v in want_losses]}, relative {rel} (limits "
            f"{TRAIN_STEP_LOSS_RTOL}, then {TRAIN_LATER_LOSS_RTOL}); step-0 gradient over "
            f"{len(grad_err)} leaves, worst {worst} {grad_err[worst]:.3g} of its max |g| (limit "
            f"{TRAIN_GRAD_TOL}); {seconds:.2f} s, peak device memory {peak:.2f} GiB on {card}")
        if not rel[0] <= TRAIN_STEP_LOSS_RTOL:
            raise AssertionError(f"{name}: step 0's loss differs from JAX's by {rel[0]} relative")
        if not max(rel[1:]) <= TRAIN_LATER_LOSS_RTOL:
            raise AssertionError(f"{name}: the losses after Adam updates differ from JAX's by "
                                 f"{rel[1:]}")
        if not grad_err[worst] <= TRAIN_GRAD_TOL:
            raise AssertionError(f"{name}: step 0's gradient of {worst} differs from JAX's by "
                                 f"{grad_err[worst]} of its max |g|")
        results[name] = {"losses": losses, "jax_losses": [float(v) for v in want_losses],
                         "loss_rel": rel, "grad_rel_worst": grad_err[worst],
                         "grad_rel_worst_leaf": worst, "grad_leaves": len(grad_err),
                         "peak_gib": peak}
        del model, renderer, optimizer, step
        torch.cuda.empty_cache()
    return results


@contextlib.contextmanager
def loss_terms_capture():
    """While active, the names of the predictions each AlphaLoss call gets
    go to the set it yields."""
    from nerftex_torch.render import loss

    real = loss.AlphaLoss.__call__
    names = set()

    def call(self, *args, **kwargs):
        names.update(k for k, v in kwargs.items() if v is not None)
        return real(self, *args, **kwargs)

    loss.AlphaLoss.__call__ = call
    try:
        yield names
    finally:
        loss.AlphaLoss.__call__ = real


def mip_jax_frame(card):
    """configs/demo_grass_mip_render.py's renderer at its own settings on the
    fixture's 64x64 rays of its first camera (radius 20) and of the second
    camera (frame2: the same pose at radius 2.5, where the grass fills
    most of the frame), with the JAX init weights (checked by digest) under
    stream_key(STREAM_PERTURB, 0): each frame's PSNR over color and alpha
    against the JAX package's render, at MIP_GOLDEN_PSNR_DB, and its drawn
    share (alpha > 0.01; frame2 at least MIP_FRAME2_DRAWN)."""
    import importlib

    from nerftex_torch.utils import rng
    from nerftex_torch.utils.util import instantiate

    inputs = np.load(os.path.join(ROOT, "tests", MIP_INPUTS))
    config = importlib.import_module("configs.demo_grass_mip_render").config
    model = mip_init_model(config, inputs)
    renderer = instantiate(dict(config["renderer_config"], model=model, device="cuda"))
    numbers = {}
    for prefix in ("frame", "frame2"):
        data = {k: inputs[f"{prefix}/{k}"] for k in ("rays_o", "rays_d", "t", "cone_scale",
                                                      "parameters")}
        with overflow_capture() as drops:
            out = renderer(**data, key=rng.stream_key(rng.STREAM_PERTURB, 0))
        color, alpha = out["color_pred"].cpu().numpy(), out["alpha_pred"].cpu().numpy()
        want_c, want_a = inputs[f"{prefix}/color"], inputs[f"{prefix}/alpha"]
        diff = np.concatenate([color - want_c, (alpha - want_a)[..., None]], -1)
        psnr = float(10 * np.log10(1 / max(float(np.mean(diff**2)), 1e-30)))
        drawn = float((want_a > 0.01).mean())
        want_drops = [tuple(inputs[f"{prefix}/overflow"].tolist())]
        log(f"grass_mip 64x64 {prefix} at full width (JAX init) vs the JAX package's render: "
            f"{psnr:.2f} dB (floor {MIP_GOLDEN_PSNR_DB}), max |diff| "
            f"{float(np.abs(diff).max()):.3g}, {drawn:.3f} of the rays drawn (port "
            f"{float((alpha > 0.01).mean()):.3f}), alpha mean {float(alpha.mean()):.4f} (JAX "
            f"{float(want_a.mean()):.4f}), dropped (hits, samples) {drops} (JAX {want_drops}) "
            f"on {card}")
        if not psnr >= MIP_GOLDEN_PSNR_DB:
            raise AssertionError(f"the grass_mip {prefix} diverged from JAX's: {psnr:.2f} dB")
        if drops != want_drops:
            raise AssertionError(f"the grass_mip {prefix} dropped {drops}, the JAX package "
                                 f"{want_drops}")
        if prefix == "frame2" and not drawn >= MIP_FRAME2_DRAWN:
            raise AssertionError(f"the grass_mip frame2 draws {drawn} of its rays, not "
                                 f"{MIP_FRAME2_DRAWN}")
        numbers[prefix] = {"psnr_db": psnr, "max_abs_diff": float(np.abs(diff).max()),
                           "drawn": drawn, "drops": drops}
    del model, renderer, out
    torch.cuda.empty_cache()
    return dict(numbers.pop("frame"), **numbers)


def main_mip(counts, card):
    """The mip phase (see the module docstring): the full-width steps
    against JAX, the user's train-then-render sequence through
    nerftex_torch.main (demo_grass_mip_train for MIP_TRAIN_STEPS steps on a
    synthetic TFRecord with the dataset's five parameters, then
    demo_grass_mip_render from the directory it trained into, the
    demo_grass_mip_imp_train run beside it), and the 64x64 full-width frame
    against JAX.  Returns (numbers, kernel rows, launch counts) per run."""
    import importlib
    import tempfile

    from nerftex_torch import main as port_main
    from nerftex_torch.models import mlp
    from nerftex_torch.tools.synth import make_synthetic_tfrecord

    reset_counts, read_counts, check_counts = counts
    numbers, rows, launches = {}, {}, {}
    t0 = time.perf_counter()
    numbers["grass_mip_steps_vs_jax"] = mip_fixture_steps(card)
    log(f"mip: full-width steps vs JAX {time.perf_counter() - t0:.1f} s")

    os.environ["NERFTEX_NO_TENSORBOARD"] = "1"
    config = importlib.import_module("configs.demo_grass_mip_train").config
    n = MIP_TRAIN_STEPS
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_mip_") as work:
        # -- the user's train command --------------------------------------------
        proxy = config["train_dataset_config"]["proxy_config"]
        t0 = time.perf_counter()
        tfr = make_synthetic_tfrecord(os.path.join(work, "grass_mip.tfr"), **TRAIN_SYNTH,
                                      n_parameters=MIP_SYNTH_PARAMETERS,
                                      b_0=tuple(proxy["b_0"]), b_1=tuple(proxy["b_1"]))
        synth_s = time.perf_counter() - t0
        cfg_path, target = write_train_config(
            work, "grass_mip_train", "demo_grass_mip_train", tfr, {"n_iters": n},
            {"i_img": n, "i_checkpoint": MIP_TRAIN_CHECKPOINT_EVERY})
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        mlp._INIT_COUNTER[0] = 0
        t0 = time.perf_counter()
        with logger_timing((10, n - 10)) as record:
            port_main.main([cfg_path])
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        train_launches, variants = read_counts()
        rate = steps_per_s(record, 10, n - 10, n // MIP_TRAIN_CHECKPOINT_EVERY - 1)
        log(f"nerftex_torch.main {cfg_path} ({n} steps, synthetic TFRecord of "
            f"{TRAIN_SYNTH['n_images']} x {TRAIN_SYNTH['size']}^2 with {sum(MIP_SYNTH_PARAMETERS)} "
            f"parameters written in {synth_s:.1f} s): {main_s:.1f} s; {rate:.2f} steps/s over "
            f"steps 10-{n - 10} (validation renders and saves excluded); validation renders "
            f"{record['render_images']} s, saves {record['save_checkpoint']} s; peak device "
            f"memory {peak:.2f} GiB; launches {train_launches}, variants {variants} on {card}")
        check_counts("grass_mip_train (main)", train_launches, variants,
                     idle=("tex_fetch", "selk_resolve", "per_ray"), want=F32_FRAME_VARIANTS)
        with open(os.path.join(target, "scalars.jsonl")) as f:
            losses = [json.loads(line)["Loss"] for line in f]
        if len(losses) != n // 10 or not np.isfinite(losses).all():
            raise AssertionError(f"{len(losses)} scalars, not {n // 10}: {losses}")
        first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
        log(f"grass_mip_train losses (every 10th step): {losses}; mean of the last five "
            f"{last5:.5f} vs the first five {first5:.5f}")
        if not last5 < 0.9 * first5:
            raise AssertionError(f"the mip loss did not fall: {first5} -> {last5}")
        ckpts = sorted(os.listdir(os.path.join(target, "checkpoints")))
        want_ckpts = sorted(f"ckpt-{s}.pkl" for s in range(
            MIP_TRAIN_CHECKPOINT_EVERY, n + 1, MIP_TRAIN_CHECKPOINT_EVERY))
        if ckpts != want_ckpts:
            raise AssertionError(f"checkpoints {ckpts}, not {want_ckpts}")
        names = sorted(os.listdir(os.path.join(target, "media", "validation", str(n))))
        if names != ["0.png", "1.png"]:
            raise AssertionError(f"validation images {names}")
        val, rows["grass_mip_train"] = check_validation_render(
            "grass_mip_train", config, target, n, counts, maps=MIP_MAPS)
        launches["grass_mip_train"] = train_launches
        numbers["grass_mip_train"] = {
            "steps": n, "steps_per_s": rate, "main_s": main_s, "peak_gib": peak,
            "loss_first5": first5, "loss_last5": last5, "checkpoints": ckpts,
            "validation_render_s": record["render_images"],
            "checkpoint_save_s": record["save_checkpoint"], **val}

        # -- demo_grass_mip_imp_train: mip_importance and the coarse terms ---------
        m = MIP_IMP_TRAIN_STEPS
        cfg_path, imp_target = write_train_config(
            work, "grass_mip_imp_train", "demo_grass_mip_imp_train", tfr, {"n_iters": m},
            {"i_summary": 1, "i_img": m, "i_checkpoint": m})
        reset_counts()
        mlp._INIT_COUNTER[0] = 0
        t0 = time.perf_counter()
        with logger_timing((2, m - 1)) as record, loss_terms_capture() as terms:
            port_main.main([cfg_path])
        torch.cuda.synchronize()
        imp_s = time.perf_counter() - t0
        imp_launches, imp_variants = read_counts()
        with open(os.path.join(imp_target, "scalars.jsonl")) as f:
            imp_losses = [json.loads(line)["Loss"] for line in f]
        imp_rate = steps_per_s(record, 2, m - 1, 0)
        log(f"nerftex_torch.main {cfg_path} (256 + 256 importance posts; {m} steps): "
            f"{imp_s:.1f} s, {imp_rate:.2f} steps/s; losses {imp_losses}; the loss got "
            f"{sorted(terms)}; launches {imp_launches}, variants {imp_variants}")
        if len(imp_losses) != m or not np.isfinite(imp_losses).all():
            raise AssertionError(f"grass_mip_imp_train losses {imp_losses}")
        if not {"color_pred_coarse", "alpha_pred_coarse"} <= terms:
            raise AssertionError(f"the mip_importance loss had no coarse terms: {sorted(terms)}")
        check_counts("grass_mip_imp_train (main)", imp_launches, imp_variants,
                     idle=("tex_fetch", "selk_resolve", "per_ray"), want=F32_FRAME_VARIANTS)
        numbers["grass_mip_imp_train"] = {"steps": m, "steps_per_s": imp_rate, "main_s": imp_s,
                                          "losses": imp_losses, "loss_terms": sorted(terms),
                                          "launches": imp_launches}

        # -- the user's render command, from the trained directory -----------------
        want_drops = [tuple(d) for d in np.load(os.path.join(ROOT, "tests", MIP_INPUTS))[
            "sweep/overflow"].tolist()]
        numbers["grass_mip"], rows["grass_mip"], launches["grass_mip"] = check_render_mode(
            "grass_mip", "demo_grass_mip_render", work, target, None, counts, card, MIP_MAPS,
            frame_mlp=True, want_drops=want_drops)

    numbers["grass_mip_jax_frame"] = mip_jax_frame(card)
    return numbers, rows, launches


@contextlib.contextmanager
def per_ray_capture():
    """While active, the n_steps [Rb] of each ray block's per-ray stage
    (DeviceInstancer._per_ray, left on the device) go to the list it
    yields, in call order."""
    from nerftex_torch.instancing.device import DeviceInstancer

    real = DeviceInstancer._per_ray
    steps = []

    def per_ray(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        steps.append(out["n_steps"])
        return out

    DeviceInstancer._per_ray = per_ray
    try:
        yield steps
    finally:
        DeviceInstancer._per_ray = real


@contextlib.contextmanager
def taken_capture():
    """While active, the samples each ray block took in every
    get_model_input_compact call (a list per call, one call per render
    chunk) go to the list it yields."""
    from nerftex_torch.instancing.device import DeviceInstancer

    real = DeviceInstancer.get_model_input_compact
    taken = []

    def call(self, rays_o, rays_d, parameters, n_samples, step_size, budget, key=None):
        out = real(self, rays_o, rays_d, parameters, n_samples, step_size, budget, key=key)
        per_block = budget * min(self.ray_block, rays_o.shape[0])
        taken.append(out["taken"].reshape(-1, per_block).sum(-1).tolist())
        return out

    DeviceInstancer.get_model_input_compact = call
    try:
        yield taken
    finally:
        DeviceInstancer.get_model_input_compact = real


@contextlib.contextmanager
def selk_check_capture(selk, keep=COMPACT_SELK_TIMED):
    """While active, every selk_resolve launch of the render path is held
    against its plain version on its own inputs as it runs
    (compare_selk_outputs; the plain calls launch no kernel) and recorded
    as selk_capture records it, the inputs of the ``keep`` launches with
    the most window slots kept for timing.  Yields (calls, totals of the
    comparisons)."""
    import nerftex_torch.instancing.device as device

    real = device.selk_resolve
    calls, kept = [], []
    totals = {"mismatches": 0, "max_abs_err": 0.0, "max_knife_edge": 0.0}

    def capture(*a, **k):
        tk0, tk1, kvalid, t_pt = a[0], a[1], a[2], a[5]
        call = {"key": (tk0.shape[0], t_pt.shape[1], tk0.shape[1], k["method"]),
                "work": selk_work(tk0, tk1, kvalid, t_pt)}
        slots = int(call["work"][0])
        if len(kept) < keep or slots > kept[0][0]:
            call["args"] = (tuple(None if x is None else x.clone() for x in a), k)
            kept.append((slots, len(calls), call))
            kept.sort(key=lambda x: x[:2])
            if len(kept) > keep:
                del kept.pop(0)[2]["args"]
        calls.append(call)
        got = real(*a, **k)
        stats = compare_selk_outputs(selk, got, a, k["method"], k["blend_range"])
        totals["mismatches"] += stats["mismatches"]
        for name in ("max_abs_err", "max_knife_edge"):
            totals[name] = max(totals[name], stats[name])
        return got

    device.selk_resolve = capture
    try:
        yield calls, totals
    finally:
        device.selk_resolve = real


def covering_budget(steps):
    """The smallest multiple of 8 samples per ray at which no ray block of
    the per-ray n_steps ``steps`` (a list of [Rb]) overflows its budget;
    with each block's sum of n_steps and its size."""
    sums = torch.stack([s.sum() for s in steps]).tolist()
    block = int(steps[0].shape[0])
    return 8 * -(-max(sums) // (8 * block)), sums, block


def frame_diff(a, b):
    """Max |a - b| over color and alpha of two renders."""
    return max(float((a[k] - b[k]).abs().max()) for k in ("color_pred", "alpha_pred"))


def compact_rows(frame, counts_launches, calls, totals, mlp_calls, tex_calls, dtype_name, texture):
    """The kernels-line rows of a compact frame: tex_fetch on the first
    launch of its busiest ray block, mlp_fused on its busiest net_chunk
    (both as busiest_capture keeps them), selk_resolve's histogram
    and summed bound over all its launches (each checked against plain as
    it ran) and its COMPACT_SELK_TIMED busiest launches timed together."""
    from nerftex_torch.kernels import mlp_fused as fused, selk_resolve as selk, tex_gather

    rows = {}
    if tex_calls:
        tex, uv, quads = tex_calls[0]
        rows["tex_fetch"] = tex_kernel_row(
            [tex_shape_row(tex_gather, tex, quads, uv,
                           f"the {frame} frame's busiest block's first launch")],
            texture)
    packed = mlp_calls[0][2]
    rows["mlp_fused"] = mlp_kernel_row(fused, packed, [mlp_row(
        fused, packed, *mlp_calls[0][:2], dtype_name, f"the {frame} frame's busiest net_chunk")])
    timed = [c for c in calls if "args" in c]
    log(f"selk_resolve on all {len(calls)} launches of the {frame} frame, against plain as they "
        f"ran: {totals['mismatches']} picks differ, max |p - plain| {totals['max_abs_err']:.3g}")
    rows["selk_resolve"] = dict(
        check_selk_frame(selk, timed, f"{frame} ({len(timed)} busiest launches)"),
        per=f"the frame's {len(timed)} launches with the most window slots",
        frame_mismatches=totals["mismatches"],
        frame_max_abs_err=totals["max_abs_err"],
        **selk_frame_record(calls, counts_launches["selk_resolve"], frame))
    return rows


def compact_render(renderer, data, key, counts, frame, want, idle=()):
    """A checking render on the compact path: kernel counts from zero,
    every selk_resolve launch against plain as it ran, the busiest MLP
    chunk and tex_fetch launch kept (busiest_capture), drops and per-block
    taken counts.  The kept MLP chunk must be all taken samples, and the
    kept tex_fetch launch (where the frame has a texture) that of the
    block that took the most.  Returns (out, launches, capture lists)."""
    from nerftex_torch.kernels import selk_resolve as selk

    reset_counts, read_counts, check_counts = counts
    reset_counts()
    t0 = time.perf_counter()
    with selk_check_capture(selk) as (calls, totals), busiest_capture() as busiest, \
            overflow_capture() as drops, taken_capture() as taken:
        out = renderer(**data, key=key)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, variants = read_counts()
    log(f"{frame} frame (first render, checking every selk_resolve launch, {first_s:.2f} s): "
        f"launches {launches}, variants {variants}, dropped (hits, samples) {drops}")
    check_counts(frame, launches, variants, idle=idle, want=want)
    most = max(sum(taken, []))
    log(f"{frame}: kept mlp_fused net_chunk holds {busiest['mlp_taken'][0]} taken rows of "
        f"{busiest['mlp_taken'][1]}; kept tex_fetch launch is of a block that took "
        f"{busiest['tex_taken']} samples (most in a block {most})")
    if busiest["mlp_taken"][0] != busiest["mlp_taken"][1]:
        raise AssertionError(f"the {frame} frame has no mlp_fused chunk of taken samples only: "
                             f"{busiest['mlp_taken']}")
    if "tex_fetch" not in idle and not busiest["tex_taken"] == most > 0:
        raise AssertionError(f"the {frame} frame's kept tex_fetch launch took "
                             f"{busiest['tex_taken']} samples, not the most in a block, {most}")
    return out, launches, {"calls": calls, "totals": totals, "mlp": busiest["mlp"],
                           "tex": busiest["tex"], "drops": drops, "taken": taken}


def main_compact(params, counts, card):
    """The compact phase (see the module docstring).  Returns (numbers,
    kernel rows, launch counts) per frame."""
    import importlib

    from nerftex_torch.ops.rays import frame_rays
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils import jax_rng, rng
    from nerftex_torch.utils.util import instantiate

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    numbers, rows, launches = {}, {}, {}
    data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])
    key = jax_rng.key(1)

    def renderer_at(budget, precision="bfloat16", compute_dtype="bfloat16"):
        model = instantiate(model_config(precision, compute_dtype), device="cuda")
        load_jax_params(model, params)
        return instantiate(dict(renderer_config(precision), sample_budget_per_ray=budget,
                                model=model, device="cuda"))

    # -- the grid frame, its per-ray steps and the covering budget --------------
    grid = renderer_at(0)
    with per_ray_capture() as steps, overflow_capture() as grid_drops:
        grid_out = grid(**data, key=key)
    b_full, sums, block = covering_budget(steps)
    cap_drops = grid_drops[0][1]
    log(f"compact: the sorted grid bench frame drops (hits, samples) {grid_drops}; its "
        f"{len(sums)} ray blocks need up to {max(sums)} samples ({max(sums) / block:.2f} per "
        f"ray): covering budget {b_full} per ray")

    # -- 1. the covering budget -----------------------------------------------------
    compact = renderer_at(b_full)
    out, launch, cap = compact_render(compact, data, key, counts, "bench_compact", FRAME_VARIANTS)
    diff = frame_diff(out, grid_out)
    psnr = golden_psnr(out)
    log(f"bench_compact (budget {b_full}): max |compact - grid| {diff:.3g} (limit "
        f"{COMPACT_MAX_DIFF}), golden {psnr:.2f} dB (floor {GOLDEN_PSNR_DB}), dropped "
        f"{cap['drops']} (grid {grid_drops}); per-block taken = per-block samples: "
        f"{sum(cap['taken'], []) == sums}")
    if not diff <= COMPACT_MAX_DIFF:
        raise AssertionError(f"the compact bench frame differs from the grid frame by {diff}")
    if not psnr >= GOLDEN_PSNR_DB:
        raise AssertionError(f"the compact bench frame diverged from golden: {psnr:.2f} dB")
    if cap["drops"] != grid_drops or sum(cap["taken"], []) != sums:
        raise AssertionError(f"the covering budget dropped {cap['drops']}, took {cap['taken']}")
    rows["bench_compact"] = compact_rows("bench_compact", launch, cap["calls"], cap["totals"],
                                         cap["mlp"], cap["tex"], "bfloat16",
                                         "smooth_checkerboard.png")
    launches["bench_compact"] = launch
    numbers["bench_compact"] = {"budget": b_full, "max_block_samples": max(sums),
                                "max_abs_diff_vs_grid": diff, "golden_psnr_db": psnr,
                                "drops": cap["drops"][0]}
    del cap

    # -- 2. the dropping budget -----------------------------------------------------
    b_drop = COMPACT_DROP_BUDGET
    want_drops = (grid_drops[0][0], cap_drops + sum(max(n - b_drop * block, 0) for n in sums))
    want_taken = [min(n, b_drop * block) for n in sums]
    dropping = renderer_at(b_drop)
    with overflow_capture() as drops, taken_capture() as taken:
        drop_out = dropping(**data, key=key)
    log(f"bench_compact at budget {b_drop}: dropped {drops} (reckoned from the grid frame's "
        f"n_steps: {want_drops}); taken per block as reckoned: {sum(taken, []) == want_taken}; "
        f"alpha mean {float(drop_out['alpha_pred'].mean()):.4f} (grid "
        f"{float(grid_out['alpha_pred'].mean()):.4f})")
    if drops != [want_drops] or sum(taken, []) != want_taken:
        raise AssertionError(f"the dropping budget dropped {drops} and took {taken}, not "
                             f"{want_drops} and {want_taken}")
    numbers["bench_compact"]["dropping"] = {"budget": b_drop, "drops": drops[0]}
    del dropping, drop_out

    # -- timing: grid and compact interleaved -----------------------------------
    times = {"grid": [], "compact": []}
    for name in ("grid", "compact", "compact", "grid", "grid", "compact"):
        r = grid if name == "grid" else compact
        t0 = time.perf_counter()
        r(**data, key=key)
        torch.cuda.synchronize()
        times[name].append(time.perf_counter() - t0)
    best = {k: min(v) for k, v in times.items()}
    log(f"bench frame, interleaved G C C G G C: sorted grid {[round(t * 1e3, 1) for t in times['grid']]} ms, "
        f"compact (budget {b_full}) {[round(t * 1e3, 1) for t in times['compact']]} ms; best "
        f"{512 * 512 / best['grid']:.1f} vs {512 * 512 / best['compact']:.1f} rays/s on {card}")
    numbers["bench_compact"].update(rays_per_s=512 * 512 / best["compact"],
                                    grid_rays_per_s=512 * 512 / best["grid"],
                                    best_ms=best["compact"] * 1e3, grid_best_ms=best["grid"] * 1e3)
    del grid, compact, out, grid_out
    torch.cuda.empty_cache()

    # -- 3. the f32 rays against the JAX package's compact render ----------------
    inputs = np.load(os.path.join(ROOT, "tests", COMPACT_INPUTS))
    sel = inputs["rays"]
    n = (int(sel.max()) // 1024 + 1) * 1024
    sub = {"parameters": data["parameters"],
           "rays_o": np.broadcast_to(np.float32([0, 0, 50.0]), (1, n, 3)).copy(),
           "rays_d": np.broadcast_to(np.float32([0, 0, 1.0]), (1, n, 3)).copy(),
           "t": np.full((1, n, 2), np.inf, np.float32),
           "cone_scale": np.zeros((1, n, 1), np.float32)}
    for k in ("rays_o", "rays_d", "t", "cone_scale"):
        sub[k][:, sel] = data[k][:, sel]
    f32 = renderer_at(int(inputs["budget"]), "float32", "float32")
    out, launch, cap = compact_render(f32, sub, key, counts, "bench_compact_f32",
                                      F32_FRAME_VARIANTS)
    color = out["color_pred"][0, sel].cpu().numpy()
    alpha = out["alpha_pred"][0, sel].cpu().numpy()
    f32_diff = max(float(np.abs(color - inputs["color"]).max()),
                   float(np.abs(alpha - inputs["alpha"]).max()))
    want_drops = [tuple(inputs["overflow"].tolist())]
    log(f"bench_compact_f32 ({len(sel)} rays of blocks {sorted(set((sel // 1024).tolist()))} at "
        f"budget {int(inputs['budget'])}, f32 dots and MLP): max |port - JAX| {f32_diff:.3g} "
        f"(limit {COMPACT_F32_MAX_DIFF}), dropped {cap['drops']} (JAX {want_drops})")
    if not f32_diff <= COMPACT_F32_MAX_DIFF:
        raise AssertionError(f"the f32 compact rays differ from JAX's by {f32_diff}")
    if cap["drops"] != want_drops:
        raise AssertionError(f"the f32 compact rays dropped {cap['drops']}, JAX {want_drops}")
    rows["bench_compact_f32"] = compact_rows("bench_compact_f32", launch, cap["calls"],
                                             cap["totals"], cap["mlp"], cap["tex"], "float32",
                                             "smooth_checkerboard.png")
    launches["bench_compact_f32"] = launch
    numbers["bench_compact_f32"] = {"max_abs_diff_vs_jax": f32_diff, "drops": cap["drops"][0]}
    del f32, out, cap
    torch.cuda.empty_cache()

    # -- 4. the mip frame --------------------------------------------------------------
    config = importlib.import_module("configs.demo_grass_mip_render").config
    mip_inputs = np.load(os.path.join(ROOT, "tests", MIP_INPUTS))
    rng.set_seed(config["seed"])
    mip_data = list(instantiate(config["test_dataset_config"]).take(1))[0]
    model = mip_init_model(config, mip_inputs)
    mip_grid = instantiate(dict(config["renderer_config"], model=model, device="cuda"))
    with per_ray_capture() as steps, overflow_capture() as mip_drops:
        mip_grid_out = mip_grid(**mip_data, key=key)
    m_full, m_sums, m_block = covering_budget(steps)
    mip = instantiate(dict(config["renderer_config"], sample_budget_per_ray=m_full, model=model,
                           device="cuda"))
    out, launch, cap = compact_render(mip, mip_data, key, counts, "grass_mip_compact",
                                      F32_FRAME_VARIANTS, idle=("tex_fetch",))
    m_diff = frame_diff(out, mip_grid_out)
    log(f"grass_mip_compact (demo_grass_mip_render's first camera, {len(m_sums)} blocks of "
        f"{m_block}, covering budget {m_full}): max |compact - grid| {m_diff:.3g} (limit "
        f"{COMPACT_MAX_DIFF}), dropped {cap['drops']} (grid {mip_drops}), alpha mean "
        f"{float(out['alpha_pred'].mean()):.4f}")
    if not m_diff <= COMPACT_MAX_DIFF:
        raise AssertionError(f"the compact mip frame differs from its grid frame by {m_diff}")
    if cap["drops"] != mip_drops or sum(cap["taken"], []) != m_sums:
        raise AssertionError(f"the compact mip frame dropped {cap['drops']}, grid {mip_drops}")
    rows["grass_mip_compact"] = compact_rows("grass_mip_compact", launch, cap["calls"],
                                             cap["totals"], cap["mlp"], cap["tex"], "float32",
                                             None)
    launches["grass_mip_compact"] = launch
    numbers["grass_mip_compact"] = {"budget": m_full, "max_abs_diff_vs_grid": m_diff,
                                    "drops": cap["drops"][0]}
    peak = torch.cuda.max_memory_allocated() / 2**30
    numbers["bench_compact"]["phase_peak_gib"] = peak
    log(f"compact phase: peak device memory {peak:.2f} GiB on {card}")
    del mip, mip_grid, model, out, cap
    torch.cuda.empty_cache()
    return numbers, rows, launches


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def spawn_parallel(job, world, work, *extra):
    """Run ``python3 chip_smoke.py --parallel-worker <job> <rank> <world>
    <port> <work> ...`` for every rank at once, each killed after
    PARALLEL_TIMEOUT_S; their logs are printed with a rank prefix, and any
    rank that does not exit 0 fails the phase.  Returns each rank's
    <work>/<job>_<rank>.json."""
    port = _free_port()
    logs, procs = [], []
    for rank in range(world):
        logs.append(open(os.path.join(work, f"{job}_{rank}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker", job, str(rank),
             str(world), str(port), work, *extra],
            cwd=ROOT, stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + PARALLEL_TIMEOUT_S
    try:
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for rank, f in enumerate(logs):
            f.seek(0)
            for line in f.read().splitlines():
                log(f"[{job} rank {rank}] {line}")
            f.close()
    bad = {rank: proc.returncode for rank, proc in enumerate(procs) if proc.returncode != 0}
    if bad:
        raise AssertionError(f"the {job} job's ranks exited {bad} (killed past "
                             f"{PARALLEL_TIMEOUT_S} s if -9)")
    out = []
    for rank in range(world):
        with open(os.path.join(work, f"{job}_{rank}.json")) as f:
            out.append(json.load(f))
    return out


def param_digest(model):
    """sha256 of a model's parameters' bytes, in order."""
    import hashlib

    h = hashlib.sha256()
    for p in model.parameters():
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def same_on_every_rank(value, what):
    """Fail unless every process of the job holds ``value``."""
    import torch.distributed as dist

    values = [None] * dist.get_world_size()
    dist.all_gather_object(values, value)
    if any(v != values[0] for v in values):
        raise AssertionError(f"{what} differs between the ranks: {values}")


def parallel_dp_step(mesh, card):
    """Phase 15 (a): config_carpet_train's model (the JAX init), renderer,
    loss and Adam at full width through make_parallel_train_step on this
    rank's half of each of tests/torch_train_inputs.npz's three batches
    (128 of 256 rays an image) under fold_in(stream_key(STREAM_PERTURB),
    s): the all-reduced loss and step-0 gradient against JAX's at the
    training phase's limits, both ranks' parameters bit-equal after every
    step; then, on rank 0, the single-process port step from the same
    init on the whole batches, its largest difference printed."""
    import importlib

    import torch.distributed as dist

    from nerftex_torch.parallel import make_parallel_train_step
    from nerftex_torch.render.checkpoint import as_jax_tree, flatten_params, load_jax_params
    from nerftex_torch.render.train import make_optimizer, make_train_step
    from nerftex_torch.utils import jax_rng, rng
    from nerftex_torch.utils.util import instantiate

    config = importlib.import_module("configs.config_carpet_train").config
    inputs = np.load(os.path.join(ROOT, "tests", "torch_train_inputs.npz"))
    want = [float(v) for v in inputs["loss"]]
    batches = [{k[len(f"batch{s}/"):]: inputs[k] for k in inputs.files
                if k.startswith(f"batch{s}/")} for s in range(len(want))]

    def build():
        rng.set_seed(config["seed"])
        model = instantiate(dict(config["model_config"], n_parameters=[1, 6]), device=mesh.device)
        load_jax_params(model, npz_params("torch_train_inputs.npz"))
        renderer = instantiate(dict(config["renderer_config"], model=model, device=mesh.device))
        optimizer = make_optimizer(model.parameters(), config["lrate"], config["lrate_decay"])
        return model, renderer, instantiate(config["loss_config"]), optimizer

    model, renderer, loss_fn, optimizer = build()
    params = {"model": model}
    step, place_params, place_batch = make_parallel_train_step(
        renderer, loss_fn, optimizer, mesh, False, [1, 1, 1.0], batches[0], params)
    place_params(params)
    base = rng.stream_key(rng.STREAM_PERTURB)
    losses, after, grad_err = [], [], {}
    t0 = time.perf_counter()
    for s, batch in enumerate(batches):
        losses.append(float(step(place_batch(batch), jax_rng.fold_in(base, s))))
        if s == 0:
            grads = flatten_params(as_jax_tree(model, lambda p: p.grad.cpu().numpy()))
            for leaf, g in grads.items():
                for name in ("grad", "grad64"):
                    ref = inputs[f"{name}/{leaf}"]
                    grad_err[(name, leaf)] = float(np.abs(g - ref).max() / np.abs(ref).max())
        same_on_every_rank(param_digest(model), f"the parameters after step {s}")
        same_on_every_rank(losses[-1], f"the loss of step {s}")
        after.append([p.detach().clone() for p in model.parameters()])
    torch.cuda.synchronize()
    dp_s = time.perf_counter() - t0
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    worst = max(grad_err, key=grad_err.get)
    log(f"dp step, {mesh.world} gloo ranks on {mesh.device}, {len(losses)} steps of 4 x 128 rays "
        f"a rank: losses {losses} vs JAX {want}, relative {rel} (limits {TRAIN_STEP_LOSS_RTOL}, "
        f"then {TRAIN_LATER_LOSS_RTOL}); all-reduced step-0 gradient worst {worst} "
        f"{grad_err[worst]:.3g} of its max |g| (limit {TRAIN_GRAD_TOL}); parameters bit-equal on "
        f"the ranks after every step; {dp_s:.2f} s for the steps on {card}")
    if not rel[0] <= TRAIN_STEP_LOSS_RTOL:
        raise AssertionError(f"the dp step's loss differs from JAX's by {rel[0]} relative")
    if not max(rel[1:]) <= TRAIN_LATER_LOSS_RTOL:
        raise AssertionError(f"the dp losses after Adam updates differ from JAX's by {rel[1:]}")
    if not grad_err[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"the all-reduced gradient of {worst} differs by {grad_err[worst]}")
    numbers = {"losses": losses, "jax_losses": want, "loss_rel": rel,
               "grad_rel_worst": grad_err[worst], "grad_rel_worst_leaf": list(worst),
               "steps_s": dp_s}
    if mesh.rank == 0:
        single_model, single_renderer, single_loss, single_opt = build()
        single = make_train_step(single_renderer, single_loss, single_opt, False, [1, 1, 1.0])
        diffs, single_losses = [], []
        for s, batch in enumerate(batches):
            on_card = {k: torch.tensor(v, device=mesh.device) for k, v in batch.items()}
            single_losses.append(float(single(on_card, jax_rng.fold_in(base, s))))
            diffs.append(max(float((p.detach() - q).abs().max())
                             for p, q in zip(single_model.parameters(), after[s])))
        log(f"dp step vs the single-process port step on the card, from the same init: losses "
            f"{single_losses} (dp {losses}), parameters max abs diff per step {diffs}")
        numbers.update(single_losses=single_losses, single_param_max_abs_diff=diffs)
    dist.barrier()
    return numbers


def parallel_carpet(mesh, counts, card, rows=False):
    """Phase 15 (b) and (c)'s frame: configs/config_carpet_render.py at its
    own render_chunk (16 chunks of 16,384 rays), the carpet operating point
    and the golden's bf16 dots (carpet_configs), key(1), through
    shard_render: the gathered frame within PARALLEL_FRAME_MAX_DIFF of the
    unsharded render on rank 0 (whose drops it must have), every rank
    launching all three kernels, their summed launches the unsharded
    render's.  With ``rows`` (rank 0 of the gloo job), the kernels against
    their plain versions at the sharded render's inputs: tex_fetch's first
    launch, mlp_fused's first net_chunk, every selk_resolve launch."""
    import importlib

    import torch.distributed as dist

    from nerftex_torch.kernels import mlp_fused as fused, selk_resolve as selk, tex_gather
    from nerftex_torch.parallel import shard_render
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils import jax_rng
    from nerftex_torch.utils.util import instantiate

    reset_counts, read_counts, check_counts = counts
    data, h, w = config_item("carpet")
    model_cfg, renderer_cfg = carpet_configs("carpet")
    chunk = importlib.import_module("configs.config_carpet_render").config[
        "renderer_config"]["render_chunk"]
    model = instantiate(model_cfg, device=mesh.device)
    load_jax_params(model, npz_params("torch_bench_inputs.npz"))
    renderer = instantiate(dict(renderer_cfg, model=model, device=mesh.device,
                                render_chunk=chunk))
    sharded = shard_render(renderer, mesh)
    captures = (selk_capture(keep_inputs=True), mlp_capture(), tex_capture()) if rows else ()
    reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack, overflow_capture() as drops:
        calls = [stack.enter_context(c) for c in captures]
        out = sharded(**data, key=jax_rng.key(1))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, variants = read_counts()
    check_counts(f"carpet_sharded rank {mesh.rank}", launches, variants)
    per_rank = [None] * mesh.world
    dist.all_gather_object(per_rank, launches)
    summed = {k: sum(r[k] for r in per_rank) for k in launches}
    numbers = {"first_render_s": first_s, "drops": drops, "launches_per_rank": per_rank,
               "render_chunk": chunk, "chunks": h * w // chunk}
    if mesh.rank == 0:
        reset_counts()
        with overflow_capture() as whole_drops:
            whole = renderer(**data, key=jax_rng.key(1))
        torch.cuda.synchronize()
        single, _ = read_counts()
        diff = max(float((out[k] - whole[k]).abs().max()) for k in ("color_pred", "alpha_pred"))
        equal = all(torch.equal(out[k], whole[k]) for k in ("color_pred", "alpha_pred"))
        psnr = frame_psnr("carpet", out, h, w)
        log(f"carpet frame through shard_render ({mesh.world} {mesh.backend} ranks, "
            f"{h * w // chunk} chunks of {chunk}): max |sharded - unsharded| {diff:.3g} (limit "
            f"{PARALLEL_FRAME_MAX_DIFF}, bit-equal {equal}); dropped {drops} vs {whole_drops}; "
            f"launches per rank {per_rank}, summed {summed}, unsharded {single}; golden "
            f"{psnr:.2f} dB (not gated: chunked draws differ from the golden's); first sharded "
            f"render {first_s:.2f} s on {card}")
        if not diff <= PARALLEL_FRAME_MAX_DIFF:
            raise AssertionError(f"the sharded carpet frame differs from the unsharded by {diff}")
        if drops != whole_drops:
            raise AssertionError(f"the sharded frame dropped {drops}, the unsharded {whole_drops}")
        if summed != single:
            raise AssertionError(f"summed launches {summed}, the unsharded render's {single}")
        numbers.update(max_abs_diff=diff, bit_equal=equal, golden_psnr_db=psnr,
                       unsharded_launches=single, launches=summed)
        del whole
    dist.barrier()
    t0 = time.perf_counter()
    sharded(**data, key=jax_rng.key(1))
    torch.cuda.synchronize()
    numbers["sharded_s"] = time.perf_counter() - t0
    dist.barrier()
    if mesh.rank == 0:
        t0 = time.perf_counter()
        renderer(**data, key=jax_rng.key(1))
        torch.cuda.synchronize()
        numbers["unsharded_s"] = time.perf_counter() - t0
        log(f"carpet frame: sharded {numbers['sharded_s']:.3f} s ({mesh.world} {mesh.backend} "
            f"ranks on one card), unsharded {numbers['unsharded_s']:.3f} s on {card}")
    if rows:
        selk_calls, mlp_calls, tex_calls = calls
        tex, uv, quads = tex_calls[0]
        packed = mlp_calls[0][2]
        numbers["rows"] = {
            "tex_fetch": tex_kernel_row([tex_shape_row(
                tex_gather, tex, quads, uv, "the sharded carpet frame's first launch, rank 0")],
                "smooth_checkerboard.png"),
            "mlp_fused": mlp_kernel_row(fused, packed, [mlp_row(
                fused, packed, *mlp_calls[0][:2], "bfloat16",
                "the sharded carpet frame's first net_chunk, rank 0")]),
            "selk_resolve": dict(check_selk_frame(selk, selk_calls, "carpet_sharded rank 0"),
                                 **selk_frame_record(selk_calls, launches["selk_resolve"],
                                                     "carpet_sharded rank 0")),
        }
        selk_calls.clear()
        mlp_calls.clear()
        tex_calls.clear()
    dist.barrier()
    return numbers


def parallel_fused(mesh, tfr, card):
    """Phase 15 (c): configs/full_carpet_train_device.py (bf16, net_chunk
    16,384, full width) on ``tfr``'s records through
    make_parallel_fused_train_step in this NCCL world of one: one capture,
    PARALLEL_FUSED_STEPS replays with the all-reduce in the graph (no
    eager step; the all-reduces issued while the graph was captured
    counted, as many as the warm-up issued), their losses and parameters
    bit-equal to a single-process FusedStep's as many replays from the
    same init; then steps/s of both, interleaved P C C P (P the
    single-process step)."""
    import importlib

    import torch.distributed as dist

    from nerftex_torch.models import mlp
    from nerftex_torch.parallel import make_parallel_fused_train_step
    from nerftex_torch.render import train as train_mod
    from nerftex_torch.utils import rng

    config = importlib.import_module("configs.full_carpet_train_device").config
    cfg = copy.deepcopy(config)
    cfg["train_dataset_config"]["data_loader_config"]["tfr_path"] = tfr
    k = PARALLEL_FUSED_STEPS

    def build():
        rng.set_seed(cfg["seed"])
        mlp._INIT_COUNTER[0] = 0
        _, models, _, step = train_mod.build_step(
            cfg["train_dataset_config"], cfg["model_config"], cfg["loss_config"], cfg["lrate"],
            cfg["lrate_decay"], cfg["renderer_config"], mesh.device, train_mod.TrainState(),
            flat_params=cfg.get("flat_params", False), steps_per_dispatch=k)
        return models, step

    models, base = build()
    fused, place_params, place_tables = make_parallel_fused_train_step(
        base.renderer, base.loss_fn, base.optimizer, base.sampler, mesh, base.composite_bkgd,
        base.bkgd_color, models, max_steps=k)
    place_params(models)
    single_models, single = build()
    if [param_digest(m) for m in models.values()] != \
            [param_digest(m) for m in single_models.values()]:
        raise AssertionError("the two steps do not start from the same parameters")
    for name in train_mod.step_counts:
        train_mod.step_counts[name] = 0
    # Each all-reduce the step issues, and whether a CUDA graph was being
    # captured on the stream that issued it.
    issued, real_all_reduce = [], dist.all_reduce

    def all_reduce(*args, **kwargs):
        issued.append(torch.cuda.is_current_stream_capturing())
        return real_all_reduce(*args, **kwargs)

    dist.all_reduce = all_reduce
    try:
        losses = fused.run(0, k)
    finally:
        dist.all_reduce = real_all_reduce
    graph = dict(train_mod.step_counts, all_reduces_captured=sum(issued),
                 all_reduces_eager=len(issued) - sum(issued))
    single_losses = single.run(0, k)
    equal = torch.equal(losses, single_losses) and all(
        torch.equal(p, q) for p, q in zip(fused._params(), single._params()))
    log(f"device-resident dp step, NCCL world of one on {mesh.device}: {graph} for {k} steps; "
        f"losses {losses.tolist()}; single-process FusedStep {single_losses.tolist()}; losses and "
        f"parameters bit-equal {equal}")
    if graph["captures"] != 1 or graph["graph_replays"] != k or graph["eager_steps"] != 0 \
            or not 0 < graph["all_reduces_captured"] == graph["all_reduces_eager"]:
        raise AssertionError(f"the dp step ran {graph}, not {k} replays of one capture with "
                             f"the warm-up's all-reduces captured")
    if not equal:
        raise AssertionError("the dp step's replays differ from the single-process step's")

    def timed(step, start):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(0, PARALLEL_RATE_STEPS, k):
            step.run(start + i, k)
        torch.cuda.synchronize()
        return PARALLEL_RATE_STEPS / (time.perf_counter() - t0)

    rates = {"single": [], "dp": []}
    start = {"single": k, "dp": k}
    for side in ("single", "dp", "dp", "single"):
        rates[side].append(timed(single if side == "single" else fused, start[side]))
        start[side] += PARALLEL_RATE_STEPS
    log(f"steps/s interleaved P C C P (P: the single-process FusedStep, C: the dp step with its "
        f"captured all-reduce; {PARALLEL_RATE_STEPS} steps a side, {k} replays a dispatch): "
        f"single {rates['single']}, dp {rates['dp']} on {card}")
    del fused, single, base
    torch.cuda.empty_cache()
    return {"graph": graph, "bit_equal": equal, "steps_per_s": rates, "losses": losses.tolist()}


def parallel_worker(job, rank, world, port, work, tfr=None):
    """One rank of phase 15's and 16's jobs (spawn_parallel): "gloo", two
    ranks on cuda:0 ((a) parallel_dp_step, then (b) parallel_carpet with
    rank 0's kernel rows), "nccl", a world of one ((c) parallel_fused on
    ``tfr``, then parallel_carpet on the device all-gather), or "tp", gloo
    ranks on cuda:0 on the TP_SHAPE mesh (phase 16 (a)
    parallel_tp_step).  Writes <work>/<job>_<rank>.json."""
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch.distributed as dist

    from nerftex_torch.kernels import build
    from nerftex_torch.parallel import init_distributed, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world = int(rank), int(world)
    build.build()
    card = card_line()
    init_distributed(f"localhost:{port}", world, rank, backend="nccl" if job == "nccl" else "gloo",
                     device="cuda:0")
    try:
        mesh = make_mesh(shape=TP_SHAPE if job == "tp" else None)
        log(f"rank {rank} of {world}, backend {mesh.backend}, device {mesh.device}, mesh "
            f"{mesh.shape}")
        counts = kernel_counts()
        if job == "tp":
            result = parallel_tp_step(mesh, counts, card)
        elif job == "gloo":
            result = {"dp_step": parallel_dp_step(mesh, card),
                      "carpet": parallel_carpet(mesh, counts, card, rows=rank == 0)}
        else:
            result = {"fused": parallel_fused(mesh, tfr, card),
                      "carpet": parallel_carpet(mesh, counts, card)}
        with open(os.path.join(work, f"{job}_{rank}.json"), "w") as f:
            json.dump(result, f)
    finally:
        dist.destroy_process_group()


def main_parallel(card, tfr):
    """Phase 15 (module docstring): two gloo ranks on the card, then an NCCL
    world of one on ``tfr``; returns (numbers, the carpet_sharded kernel
    rows, their summed launches)."""
    import tempfile

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_parallel_") as work:
        gloo = spawn_parallel("gloo", 2, work)
        nccl = spawn_parallel("nccl", 1, work, tfr)
    carpet = gloo[0]["carpet"]
    rows = carpet.pop("rows")
    numbers = {"dp_step": gloo[0]["dp_step"], "carpet_sharded_gloo": carpet,
               "fused_nccl": nccl[0]["fused"], "carpet_sharded_nccl": nccl[0]["carpet"]}
    log(f"phase parallel on {card}: {json.dumps(numbers)}")
    return numbers, rows, carpet["launches"]


def tp_grads(model, mesh):
    """{"trunk/0/w": gradient, ...} of a tensor-parallel model's whole
    parameters (the JAX layout), its blocks' gradients gathered over the
    model row."""
    shardings = model.sharded_trunk.shardings
    grads = {}
    for pname, p in model.named_parameters():
        g = p.grad
        if pname in shardings:
            g = mesh.model_all_gather(g, shardings[pname].spec.index("model"))
        layer, _, kind = pname.rpartition(".")
        leaf = layer.replace(".", "/") + ("/w" if kind == "weight" else "/b")
        grads[leaf] = (g.T if kind == "weight" else g).cpu().numpy()
    return grads


def parallel_tp_step(mesh, counts, card):
    """Phase 16 (a): config_carpet_train's model (the JAX init), renderer,
    loss and Adam at full width through make_parallel_train_step with
    shard_model on the (1, 2) mesh: each rank holds its blocks of the 8 x
    256 trunk (the skip layer's [328, 256] weight split 164 input rows a
    rank) and renders every ray of tests/torch_train_inputs.npz's three
    batches under fold_in(stream_key(STREAM_PERTURB), s).  On rank 0 the
    single-process port step from the same init takes the same steps
    (after one untimed step of a throwaway model); the order is P C C P (P: three single steps, C: three tensor-parallel
    steps), each step timed to its loss on the host.  Gates: the loss
    and the gathered step-0 gradient against JAX's at the training phase's
    limits, the losses the same on both ranks, the gathered parameters
    after three steps within TP_PARAM_TOL of the single step's (a leaf
    beyond it passes only where each element beyond is an Adam sign flip
    on a near-zero gradient: at most 2 x lrate a step, its step-0
    gradient under 1e-3 of the leaf's max |g|); then, inside gathered,
    rank 0 renders a TP_VALIDATION frame of the trained model through
    ParamNerf.infer with the kernel counts reset just before and read just
    after (mlp_fused only, every launch wgmma_tf32x3), within
    TRAIN_PLAIN_MAX_DIFF of the plain MLP's render, the kernel against its
    plain version at the frame's first net_chunk (the carpet_tp row)."""
    import importlib

    import torch.distributed as dist

    from nerftex_torch.kernels import mlp_fused as fused
    from nerftex_torch.ops.rays import frame_rays
    from nerftex_torch.parallel import gathered, make_parallel_train_step
    from nerftex_torch.render.checkpoint import (as_jax_tree, export_jax_params, flatten_params,
                                                 load_jax_params)
    from nerftex_torch.render.train import make_optimizer, make_train_step
    from nerftex_torch.utils import jax_rng, rng
    from nerftex_torch.utils.util import instantiate

    reset_counts, read_counts, check_counts = counts
    config = importlib.import_module("configs.config_carpet_train").config
    inputs = np.load(os.path.join(ROOT, "tests", "torch_train_inputs.npz"))
    want = [float(v) for v in inputs["loss"]]
    n = len(want)
    batches = [{k[len(f"batch{s}/"):]: inputs[k] for k in inputs.files
                if k.startswith(f"batch{s}/")} for s in range(n)]
    base = rng.stream_key(rng.STREAM_PERTURB)

    def build():
        rng.set_seed(config["seed"])
        model = instantiate(dict(config["model_config"], n_parameters=[1, 6]), device=mesh.device)
        load_jax_params(model, npz_params("torch_train_inputs.npz"))
        renderer = instantiate(dict(config["renderer_config"], model=model, device=mesh.device))
        optimizer = make_optimizer(model.parameters(), config["lrate"], config["lrate_decay"])
        return model, renderer, instantiate(config["loss_config"]), optimizer

    def timed_steps(step, place, first, after_step0=None):
        """Steps first .. first + n - 1 over the batches (``place``d);
        (losses, seconds in the steps), ``after_step0()`` run outside the
        timing after step 0."""
        losses, seconds = [], 0.0
        for s in range(first, first + n):
            batch = place(batches[s % n])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(batch, jax_rng.fold_in(base, s))))
            seconds += time.perf_counter() - t0
            if s == 0 and after_step0 is not None:
                after_step0()
        return losses, seconds

    def on_card(batch):
        return {k: torch.tensor(v, device=mesh.device) for k, v in batch.items()}

    rates = {"single": [], "tp": []}
    if mesh.rank == 0:  # P, after one untimed step of a throwaway model (CUDA and cuBLAS set-up)
        warm_model, warm_renderer, warm_loss, warm_opt = build()
        make_train_step(warm_renderer, warm_loss, warm_opt, False, [1, 1, 1.0])(
            on_card(batches[0]), jax_rng.fold_in(base, 0))
        del warm_model, warm_renderer, warm_loss, warm_opt
        s_model, s_renderer, s_loss, s_opt = build()
        single = make_train_step(s_renderer, s_loss, s_opt, False, [1, 1, 1.0])
        grads0 = {}
        single_losses, secs = timed_steps(single, on_card, 0, lambda: grads0.update(
            flatten_params(as_jax_tree(s_model, lambda p: p.grad.cpu().numpy()))))
        rates["single"].append(n / secs)
        single_after = flatten_params(export_jax_params(s_model))
    dist.barrier()

    model, renderer, loss_fn, optimizer = build()  # C
    params = {"model": model}
    step, place_params, place_batch = make_parallel_train_step(
        renderer, loss_fn, optimizer, mesh, False, [1, 1, 1.0], batches[0], params,
        shard_model=True)
    place_params(params)
    blocks = {k: list(p.shape) for k, p in model.named_parameters()
              if k in model.sharded_trunk.shardings}
    grad_err = {}

    def gradient_errors():
        for leaf, g in tp_grads(model, mesh).items():
            for name in ("grad", "grad64"):
                ref = inputs[f"{name}/{leaf}"]
                grad_err[(name, leaf)] = float(np.abs(g - ref).max() / np.abs(ref).max())

    losses, secs = timed_steps(step, place_batch, 0, gradient_errors)
    rates["tp"].append(n / secs)
    with gathered(params, mesh):
        tp_after = flatten_params(export_jax_params(model))
    same_on_every_rank(losses, "the tensor-parallel losses")
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, want)]
    worst = max(grad_err, key=grad_err.get)
    log(f"tp step, mesh {mesh.shape} of gloo ranks on {mesh.device}, blocks {blocks}: losses "
        f"{losses} vs JAX {want}, relative {rel} (limits {TRAIN_STEP_LOSS_RTOL}, then "
        f"{TRAIN_LATER_LOSS_RTOL}); gathered step-0 gradient worst {worst} "
        f"{grad_err[worst]:.3g} of its max |g| (limit {TRAIN_GRAD_TOL})")
    if not rel[0] <= TRAIN_STEP_LOSS_RTOL:
        raise AssertionError(f"the tp step's loss differs from JAX's by {rel[0]} relative")
    if not max(rel[1:]) <= TRAIN_LATER_LOSS_RTOL:
        raise AssertionError(f"the tp losses after Adam updates differ from JAX's by {rel[1:]}")
    if not grad_err[worst] <= TRAIN_GRAD_TOL:
        raise AssertionError(f"the gathered gradient of {worst} differs by {grad_err[worst]}")
    _, secs = timed_steps(step, place_batch, n)  # C
    rates["tp"].append(n / secs)
    numbers = {"mesh": list(mesh.shape), "blocks": blocks, "losses": losses, "jax_losses": want,
               "loss_rel": rel, "grad_rel_worst": grad_err[worst],
               "grad_rel_worst_leaf": list(worst)}
    if mesh.rank == 0:
        diffs = {leaf: float(np.abs(tp_after[leaf] - v).max()) for leaf, v in
                 single_after.items()}
        flips = {}
        for leaf, d in diffs.items():
            if d <= TP_PARAM_TOL:
                continue
            beyond = np.abs(tp_after[leaf] - single_after[leaf]) > TP_PARAM_TOL
            g = np.abs(grads0[leaf])
            explained = (np.abs(tp_after[leaf] - single_after[leaf])[beyond]
                         <= 2 * config["lrate"] * n) & (g[beyond] < 1e-3 * g.max())
            if not explained.all():
                raise AssertionError(f"the tp parameters of {leaf} after {n} steps differ from "
                                     f"the single-process step's by {d} (limit {TP_PARAM_TOL}), "
                                     f"not only at Adam sign flips of near-zero gradients")
            flips[leaf] = int(beyond.sum())
        worst_leaf = max(diffs, key=diffs.get)
        log(f"tp step vs the single-process port step after {n} steps from the same init: "
            f"single losses {single_losses} (tp {losses}); parameters worst {worst_leaf} "
            f"{diffs[worst_leaf]:.3g} (limit {TP_PARAM_TOL}), sign flips beyond it {flips}")
        _, secs = timed_steps(single, on_card, n)  # P
        rates["single"].append(n / secs)
        numbers.update(single_losses=single_losses, param_max_abs_diff=diffs[worst_leaf],
                       param_max_abs_diff_leaf=worst_leaf, sign_flips=flips)
    log(f"tp steps/s P C C P on {card}: single {rates['single']}, tp {rates['tp']}")
    numbers["steps_per_s"] = rates
    dist.barrier()

    v = TP_VALIDATION
    data = frame_rays(v["size"], v["size"], np.asarray(v["eye"]), v["angle"], v["parameters"],
                      config["train_dataset_config"]["proxy_config"]["b_0"],
                      config["train_dataset_config"]["proxy_config"]["b_1"])
    with gathered(params, mesh):
        if mesh.rank == 0:
            reset_counts()
            with mlp_capture() as mlp_calls:
                out = renderer(**data, training=False, key=jax_rng.key(0))
            torch.cuda.synchronize()
            launches, variants = read_counts()
            check_counts("carpet_tp validation", launches, variants,
                         idle=("tex_fetch", "selk_resolve", "per_ray"), want=F32_FRAME_VARIANTS)
            with mlp_wrap(lambda real, *args: real.mlp_fused_plain(*args)):
                plain = renderer(**data, training=False, key=jax_rng.key(0))
            plain_diff = max(float((out[k] - plain[k]).abs().max())
                             for k in ("color_pred", "alpha_pred"))
            ref = s_renderer(**data, training=False, key=jax_rng.key(0))
            single_diff = max(float((out[k] - ref[k]).abs().max())
                              for k in ("color_pred", "alpha_pred"))
            log(f"tp validation frame ({v['size']}^2, the gathered model after {2 * n} steps): "
                f"launches {launches}, max |kernel - plain MLP| {plain_diff:.3g} (limit "
                f"{TRAIN_PLAIN_MAX_DIFF}), vs the single-process model after the same steps "
                f"{single_diff:.3g}; alpha mean {float(out['alpha_pred'].mean()):.4f}")
            if not plain_diff <= TRAIN_PLAIN_MAX_DIFF:
                raise AssertionError(f"the tp validation frame through the kernel differs from "
                                     f"the plain MLP's by {plain_diff}")
            pos_map, dir_map, packed = mlp_calls[0]
            numbers["row"] = mlp_kernel_row(fused, packed, [mlp_row(
                fused, packed, pos_map, dir_map, "float32",
                "the carpet_tp validation frame's first net_chunk")])
            numbers.update(launches=launches, validation_plain_max_abs_diff=plain_diff,
                           validation_vs_single_max_abs_diff=single_diff)
    dist.barrier()
    return numbers


def tp_refusal(card):
    """Phase 16 (b): make_parallel_train_step with shard_model on a mesh
    with tp 2 refuses config_grass_filtered_train's full-width model on
    the card before any collective (its row-parallel skip layer is [337,
    256]), as the JAX package refuses to place it; config_carpet_train's
    model places at tp 2 and 4."""
    import importlib

    from nerftex_torch.parallel import Mesh, make_parallel_train_step, model_shardings
    from nerftex_torch.utils import rng
    from nerftex_torch.utils.util import instantiate

    models = {}
    for name, n_parameters in (("config_grass_filtered_train", [2, 3]),
                               ("config_carpet_train", [1, 6])):
        config = importlib.import_module(f"configs.{name}").config
        rng.set_seed(config["seed"])
        models[name] = instantiate(dict(config["model_config"], n_parameters=n_parameters),
                                   device="cuda")
    try:
        make_parallel_train_step(None, None, None, Mesh(0, 2, "cuda", tp=2), False,
                                 [1, 1, 1.0], {}, {"model": models["config_grass_filtered_train"]},
                                 shard_model=True)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("the grass_filtered model was not refused at tp 2")
    if "trunk layer 5" not in refused or "337" not in refused:
        raise AssertionError(f"the refusal names another leaf: {refused}")
    placed = {}
    for tp in (2, 4):
        specs = model_shardings({"model": models["config_carpet_train"]},
                                Mesh(0, tp, "cuda", tp=tp))["model"]
        placed[tp] = sum(1 for s in specs.values() if s.spec)
    log(f"tp refusal on {card}: grass_filtered at tp 2 raised ValueError: {refused}; carpet "
        f"places {placed[2]} and {placed[4]} sharded leaves at tp 2 and 4")
    return {"grass_filtered_tp2": refused, "carpet_sharded_leaves": placed}


def _numpy_swatch(view):
    """The numpy integrator's u8 image (as encode_png quantises it) of
    view ``view`` of phase 16's synthetic shard.  Runs in a worker
    process."""
    from nerftex_torch.tools import synth

    pose, params = synth.swatch_views(view + 1, SYNTH_SHARD["n_parameters"],
                                      seed=SYNTH_SHARD["seed"])[view]
    rgba = synth.render_swatch(pose, params, SYNTH_SHARD["n_parameters"][0], SYNTH_SHARD["size"],
                               0.63, np.asarray((-1.5, -1.3, -0.2)), np.asarray((1.3, 1.3, 1.9)))
    return np.clip(rgba * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _gen_assets(out):
    """nerftex_torch.tools.gen_assets (seed 0, and SCALE_ANCHORS scale
    anchors) into ``out``: {file: equal to meshes/<file>}.  Runs in a
    worker process."""
    from nerftex_torch.tools import gen_assets

    gen_assets.generate(out, seed=0)
    gen_assets.generate_scale_anchors(out, SCALE_ANCHORS, 0)
    equal = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name), "rb") as f, \
                open(os.path.join(ROOT, "meshes", name), "rb") as g:
            equal[name] = f.read() == g.read()
    return equal


def synth_shard(work, card):
    """Phase 16 (c): make_synthetic_tfrecord(backend="torch") writes the
    full-scale carpet dataset's first shard (SYNTH_SHARD: 100 views at
    512^2, n_parameters (1, 6), seed 0) with the march on the card; each
    view's render call (the host's rays, swatch_rays, timed on their own;
    the march; the u8 image back) and its PNG encode on the host are timed
    apart.  Returns (numbers, the shard's path)."""
    from nerftex_torch.data import tfrecord
    from nerftex_torch.tools import synth

    times = {"render": [], "rays": [], "encode": []}
    real_make, real_encode, real_rays = (synth.make_swatch_renderer, synth._encode_png_u8,
                                         synth.swatch_rays)

    def rays(*args):
        t0 = time.perf_counter()
        out = real_rays(*args)
        times["rays"].append(time.perf_counter() - t0)
        return out

    def make(*args, **kwargs):
        render = real_make(*args, **kwargs)

        def timed(pose, params):
            t0 = time.perf_counter()
            out = render(pose, params)  # ends in the u8 image's copy to the host
            times["render"].append(time.perf_counter() - t0)
            return out

        return timed

    def encode(arr):
        t0 = time.perf_counter()
        out = real_encode(arr)
        times["encode"].append(time.perf_counter() - t0)
        return out

    synth.make_swatch_renderer, synth._encode_png_u8, synth.swatch_rays = make, encode, rays
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        path = synth.make_synthetic_tfrecord(os.path.join(work, "carpet_full.tfr"),
                                             backend="torch", **SYNTH_SHARD)
    finally:
        synth.make_swatch_renderer, synth._encode_png_u8, synth.swatch_rays = (
            real_make, real_encode, real_rays)
    total_s = time.perf_counter() - t0
    shard = os.path.join(work, "carpet_full-00000-of-00001.tfr")
    records = list(tfrecord.read_records(shard))
    if len(records) != SYNTH_SHARD["n_images"] or len(times["render"]) != len(records):
        raise AssertionError(f"the shard holds {len(records)} records, {len(times['render'])} "
                             f"renders")
    numbers = {"views": len(records), "size": SYNTH_SHARD["size"], "total_s": total_s,
               "render_ms_per_view": 1e3 * float(np.mean(times["render"][1:])),
               "host_rays_ms_per_view": 1e3 * float(np.mean(times["rays"][1:])),
               "first_render_ms": 1e3 * times["render"][0],
               "encode_ms_per_view": 1e3 * float(np.mean(times["encode"])),
               "shard_bytes": os.path.getsize(shard),
               "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    log(f"device synth shard on {card}: {len(records)} views at {SYNTH_SHARD['size']}^2 in "
        f"{total_s:.2f} s; render {numbers['render_ms_per_view']:.2f} ms a view (of which the "
        f"host's rays {numbers['host_rays_ms_per_view']:.2f} ms; the first view "
        f"{numbers['first_render_ms']:.1f} ms), PNG encode on the host "
        f"{numbers['encode_ms_per_view']:.2f} ms a view, {numbers['shard_bytes']} bytes, peak "
        f"device memory {numbers['peak_gib']:.2f} GiB")
    return numbers, shard


def main_tensor_parallel(card):
    """Phase 16 (module docstring): gen_assets starts in a worker process
    (one core, its arrays in cache), then the tensor-parallel step in two
    gloo ranks, the refusal, the device synth shard, and the numpy
    integrator on the shard's first views in worker processes.  Returns
    (numbers, the carpet_tp kernel rows, their launches)."""
    import concurrent.futures
    import multiprocessing
    import tempfile

    from nerftex_torch.data import tfrecord
    from nerftex_torch.utils.image import decode_png_u8

    torch.cuda.empty_cache()
    spawn = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(dir=ROOT, prefix="_tp_") as work, \
            concurrent.futures.ProcessPoolExecutor(1, mp_context=spawn) as assets_pool:
        assets = assets_pool.submit(_gen_assets, os.path.join(work, "meshes"))
        tp = spawn_parallel("tp", TP_SHAPE[0] * TP_SHAPE[1], work)
        numbers = {"tp_step": tp[0], "refusal": tp_refusal(card)}
        numbers["synth"], shard = synth_shard(work, card)
        t0 = time.perf_counter()
        with concurrent.futures.ProcessPoolExecutor(SYNTH_CHECK_VIEWS, mp_context=spawn) as pool:
            want = list(pool.map(_numpy_swatch, range(SYNTH_CHECK_VIEWS)))
        assets = assets.result()
        workers_s = time.perf_counter() - t0
        images = [tfrecord.parse_example(r)["image"] for _, r in
                  zip(range(SYNTH_CHECK_VIEWS), tfrecord.read_records(shard))]
    diffs = []
    for i, (png, ref) in enumerate(zip(images, want)):
        d = np.abs(decode_png_u8(png).astype(np.int32) - ref.astype(np.int32))
        diffs.append({"max_u8": int(d.max()), "share": float((d > 0).mean())})
    log(f"device synth vs the numpy integrator on the first {SYNTH_CHECK_VIEWS} views: {diffs} "
        f"(limits {SYNTH_MAX_U8} levels, share {SYNTH_MAX_SHARE}); gen_assets vs meshes/: "
        f"{assets}; the numpy integrator's workers {workers_s:.1f} s")
    if any(d["max_u8"] > SYNTH_MAX_U8 or d["share"] >= SYNTH_MAX_SHARE for d in diffs):
        raise AssertionError(f"the device synth images leave the numpy integrator's: {diffs}")
    if len(assets) != 8 or not all(assets.values()):
        raise AssertionError(f"gen_assets differs from the committed meshes: {assets}")
    numbers["synth"]["vs_numpy"] = diffs
    numbers["gen_assets"] = assets
    rows = {"mlp_fused": tp[0].pop("row")}
    launches = tp[0].pop("launches")
    log(f"phase tensor parallel and tools on {card}: {json.dumps(numbers)}")
    return numbers, rows, launches


# -- phase 17: the device instancer against the host oracle ------------------


class FixedOffsets(np.random.RandomState):
    """The oracle's generator with every per-ray stratified offset at 0.5,
    the device's ``deterministic_offset``, so that both sample the same
    arc positions; its overlap draws (randint, choice) are the seeded
    RandomState's."""

    def uniform(self, low=0.0, high=1.0, size=None):
        return low + 0.5 * (high - low)


def oracle_scene_view(scene):
    """A shallow copy of ``scene`` for the oracle's sampling run, with
    ``nearest`` picks (the per-sample reference of the device's nearest
    run; the random and blended picks are held to the oracle's rule at the
    device's own samples) and without its texture slots (the exact
    closest-point lookup is held on a strided subset instead) or its
    shadow rays (held at the device's own shadow points instead), neither
    of which any compared output reads."""
    view = copy.copy(scene)
    view.instance_sampling_method = "nearest"
    view.texture_parameter_idxs = []
    view.cast_shadow_rays = False
    return view


def oracle_ray_geometry(scene, o, d):
    """The oracle's per-ray geometry, as get_model_input derives it: the
    instances' clipped intervals and the first mesh hit's t (inf on a
    miss)."""
    from nerftex_torch.instancing import oracle

    intervals = oracle.ray_box_events(scene, o, d)[1]
    t_mesh = np.inf
    for mesh in ([scene.base_mesh] if scene.base_mesh is not None else []) + scene.aux_meshes:
        hit = oracle.mesh_first_hit(mesh, o, d)
        if hit is not None:
            t_mesh = min(t_mesh, hit[0])
    return intervals, t_mesh


def oracle_pick_rays(scene, rays_o, rays_d, n_hit, n_miss):
    """Ray indices of a frame: n_hit rays the oracle sees hit and n_miss
    that it sees miss, each spread evenly over the hits (misses) among
    every stride-th ray of the frame; and the oracle's geometry of the
    kept rays."""
    n = len(rays_o)
    stride = max(1, n // (ORACLE_SCAN * (n_hit + n_miss)))
    geom = {}
    while True:
        for i in range(0, n, stride):
            if i not in geom:
                geom[i] = oracle_ray_geometry(scene, rays_o[i], rays_d[i])
        hits = [i for i in range(0, n, stride) if geom[i][0] or np.isfinite(geom[i][1])]
        misses = [i for i in range(0, n, stride) if i not in set(hits)]
        if len(hits) >= n_hit and len(misses) >= n_miss:
            break
        if stride == 1:
            raise AssertionError(f"{len(hits)} hit and {len(misses)} missing rays in the "
                                 f"frame; need {n_hit} and {n_miss}")
        stride = max(1, stride // 2)
    keep = [hits[j] for j in np.linspace(0, len(hits) - 1, n_hit).astype(int)]
    keep += [misses[j] for j in np.linspace(0, len(misses) - 1, n_miss).astype(int)]
    return np.asarray(keep), [geom[i] for i in keep], stride


def oracle_active(intervals, t_mesh, t_pt):
    """The oracle's active instances at world t_pt (get_model_input's set,
    with its nearest-interval fallback)."""
    active = [inst for inst, (t0, t1) in intervals.items() if t0 <= t_pt < t1 and t0 < t_mesh]
    if not active:
        active = [min(intervals, key=lambda j: abs(intervals[j][0] - t_pt))]
    return sorted(active)


def oracle_on_boundary(intervals, inst, t_pt):
    """Whether t_pt lies within ORACLE_EDGE of an end of inst's interval."""
    if inst not in intervals:
        return False
    t0, t1 = intervals[inst]
    return min(abs(t_pt - t0), abs(t_pt - t1)) < ORACLE_EDGE


def oracle_per_ray(name, dev, orc, step, stats):
    """hit, per-ray sample counts (knife-edge arcs counted), dists, the t
    spacing re-based to each ray's first sample (tests/test_device_instancer.py
    _compare), alpha_last and color_last.  Returns the per-ray sample counts
    compared."""
    if not np.array_equal(dev["hit"], orc["hit"]):
        bad = np.nonzero(dev["hit"] != orc["hit"])[0]
        raise AssertionError(f"oracle {name}: hit differs on rays {bad.tolist()}")
    nd = (dev["dists"] > 0).sum(1)
    no = (orc["dists"] > 0).sum(1)
    total = orc["dists"].astype(np.float64).sum(1)
    frac = total / step
    knife = np.abs(frac - np.round(frac)) * step < ORACLE_EDGE
    if not np.array_equal(nd[~knife], no[~knife]):
        bad = np.nonzero((nd != no) & ~knife)[0]
        raise AssertionError(f"oracle {name}: sample counts differ on rays {bad.tolist()}: "
                             f"device {nd[bad].tolist()}, oracle {no[bad].tolist()}")
    stats["knife_edge_rays"] = int((knife & (nd != no)).sum())
    stats["rays"] = len(nd)
    n = np.minimum(nd, no)
    errs = {"dists": np.abs(dev["dists"][~knife] - orc["dists"][~knife]),
            "alpha_last": np.abs(dev["alpha_last"] - orc["alpha_last"]),
            "color_last": np.abs(dev["color_last"] - orc["color_last"])}
    spacing = [np.abs(np.diff(dev["t"][r, :n[r]]) - np.diff(orc["t"][r, :n[r]]))
               for r in range(len(n)) if n[r] > 1]
    errs["t_spacing"] = np.concatenate(spacing) if spacing else np.zeros(1)
    for key, err in errs.items():
        worst = float(err.max()) if err.size else 0.0
        stats.setdefault("max_err", {})[key] = max(stats.get("max_err", {}).get(key, 0.0),
                                                   worst)
        if not worst <= ORACLE_TOLS[key]:
            raise AssertionError(f"oracle {name}: {key} differs by {worst} (limit "
                                 f"{ORACLE_TOLS[key]})")
    return n


def oracle_local_frames(scene, inst, pts_w, rays_d):
    """The oracle's local point and direction of each sample in instance
    inst [M]: inverse[inst] pts_w + trans, dir_inverse[inst] rays_d."""
    inv = np.asarray(scene.inverse, np.float32).reshape(-1, 4, 4)[inst]
    dinv = np.asarray(scene.dir_inverse, np.float32).reshape(-1, 3, 3)[inst]
    pts = np.einsum("mij,mj->mi", inv[:, :3, :3], pts_w) + inv[:, :3, 3]
    return pts, np.einsum("mij,mj->mi", dinv, rays_d)


def record_err(stats, key, err):
    if err.size:
        stats["max_err"][key] = max(stats["max_err"].get(key, 0.0), float(err.max()))
    if not stats["max_err"].get(key, 0.0) <= ORACLE_TOLS[key]:
        raise AssertionError(f"oracle {stats['scene']}: {key} differs by "
                             f"{stats['max_err'][key]} (limit {ORACLE_TOLS[key]})")


def pick_d2_error(o, t, anchors):
    """The float32 error bound of the device's anchor distance d^2 = a +
    2 t b + t^2 (a = |o - c|^2, b = d . (o - c)), whose terms cancel to
    d^2 near an anchor: ORACLE_PICK_ULPS ulps of the largest term (as
    tests/test_torch_instancer.py _near_ties bounds it, with 64)."""
    a = np.sum((np.asarray(o, np.float64) - anchors) ** 2, -1)
    return float(ORACLE_PICK_ULPS * 2.0**-24 * np.max(a + t * t))


def oracle_picks(name, scene, dev, orc, geom, rays_o, rays_d, n, method, stats):
    """Each compared sample's pick.  ``nearest``: the device's instance_id
    equals the oracle's at the same arc position except at ties (anchor
    distances within ORACLE_EDGE) and interval-boundary knife edges;
    ``random`` and ``nearest_blend``: the device's pick lies among the
    oracle's active instances at its sample (or on a boundary) and its
    alpha_weight is that instance's weight under _select_instance's rule
    (the active count; 1 / p_i), the blended weights' mean relative error
    within ORACLE_BLEND_BIAS.  The local point and direction of the
    device's pick against the oracle's transforms wherever the pick is the
    oracle's or among its active set."""
    ties = wide_ties = edges = blend_edges = 0
    origins = np.asarray(scene.origins, np.float64).reshape(-1, 3)
    rows, cols = np.nonzero(np.arange(dev["t"].shape[1])[None, :] < n[:, None])
    ids = dev["instance_id"][rows, cols]
    t_dev = dev["t"][rows, cols]
    pts_w = rays_o[rows] + t_dev[:, None] * rays_d[rows]
    ok = np.ones(len(rows), bool)
    w_err, bias = [], []
    for m, (r, i) in enumerate(zip(rows, cols)):
        intervals, t_mesh = geom[r]
        inst = int(ids[m])
        if method == "nearest":
            want = int(orc["instance_id"][r, i])
            if inst == want:
                continue
            if any(oracle_on_boundary(intervals, j, float(t_dev[m])) for j in (inst, want)):
                edges += 1
                ok[m] = False
                continue
            active = oracle_active(intervals, t_mesh, float(t_dev[m]))
            if inst in active and want in active:
                p = pts_w[m].astype(np.float64)
                d2 = [float(np.sum((p - origins[j]) ** 2)) for j in (inst, want)]
                gap = abs(np.sqrt(d2[0]) - np.sqrt(d2[1]))
                if gap < ORACLE_EDGE or abs(d2[0] - d2[1]) <= pick_d2_error(
                        rays_o[r], float(t_dev[m]), origins[[inst, want]]):
                    ties += 1
                    wide_ties += gap >= ORACLE_EDGE
                    ok[m] = False
                    continue
                raise AssertionError(f"oracle {name}: ray {r} sample {i} picked instance {inst}, "
                                     f"the oracle {want}, anchor distance gap {gap}")
        else:
            active = oracle_active(intervals, t_mesh, float(t_dev[m]))
        if inst not in active:
            if oracle_on_boundary(intervals, inst, float(t_dev[m])) or any(
                    oracle_on_boundary(intervals, j, float(t_dev[m])) for j in active):
                edges += 1
                ok[m] = False
                continue
            raise AssertionError(f"oracle {name}: ray {r} sample {i} (t {t_dev[m]}) picked "
                                 f"instance {inst}, not among the oracle's active {active}")
        if method == "nearest":
            continue
        if len(active) == 1:
            want_w = 1.0
        elif method == "random":
            want_w = float(len(active))
        else:
            d = np.array([np.linalg.norm(pts_w[m] - scene.origins[j]) for j in active])
            w = np.maximum(0.2 * scene.patch_scale + d.min() - d, 0.0)
            p = w / w.sum()
            want_w = float(1.0 / p[active.index(inst)]) if p[active.index(inst)] > 0 else np.inf
        got = float(dev["alpha_weight"][r, i])
        w_err.append(abs(got - want_w) / max(1.0, abs(want_w)))
        if method == "nearest_blend" and len(active) > 1 and np.isfinite(want_w):
            bias.append((got - want_w) / want_w)
        if method == "nearest_blend" and w_err[-1] > ORACLE_TOLS["alpha_weight"]:
            # The device's anchor distances carry the pick formula's
            # float32 error: the weight's range under that error.
            err_d = np.array([pick_d2_error(rays_o[r], float(t_dev[m]), origins[[j]])
                              for j in active]) / (2 * np.maximum(d, 1e-30))
            eps = err_d + err_d[np.argmin(d)]
            k = active.index(inst)
            lo = (w.sum() - eps.sum()) / (w[k] + eps[k])
            hi = (w.sum() + eps.sum()) / (w[k] - eps[k]) if w[k] > eps[k] else np.inf
            if not lo * (1 - ORACLE_TOLS["alpha_weight"]) <= got <= hi * (
                    1 + ORACLE_TOLS["alpha_weight"]):
                raise AssertionError(
                    f"oracle {name}: ray {r} sample {i} weight {got} of instance {inst}, the "
                    f"oracle's rule {want_w} (range {lo}-{hi} under the pick formula's "
                    f"float32 error)")
            w_err.pop()
            blend_edges += 1
    record_err(stats, "alpha_weight", np.asarray(w_err) if method != "nearest" else np.zeros(0))
    pts_l, dirs_l = oracle_local_frames(scene, ids[ok], pts_w[ok], rays_d[rows[ok]])
    record_err(stats, "pts", np.abs(dev["pts"][rows[ok], cols[ok]] - pts_l))
    record_err(stats, "rays_d", np.abs(dev["rays_d"][rows[ok], cols[ok]] - dirs_l))
    if method == "nearest":
        same = ok & (ids == orc["instance_id"][rows, cols])
        record_err(stats, "pts", np.abs(dev["pts"][rows[same], cols[same]]
                                        - orc["pts"][rows[same], cols[same]]))
        record_err(stats, "rays_d", np.abs(dev["rays_d"][rows[same], cols[same]]
                                           - orc["rays_d"][rows[same], cols[same]]))
    stats["samples"] = stats.get("samples", 0) + len(rows)
    stats.setdefault("ties", {})[method] = ties
    stats.setdefault("ties_past_edge", {})[method] = int(wide_ties)
    if method == "nearest_blend":
        # The float32 ranges are wide where an instance's weight is small;
        # the rounding is unbiased, so a systematic error shows in the mean.
        stats["blend_weights_in_float32_range"] = blend_edges
        stats["blend_weight_bias"] = float(np.mean(bias)) if bias else 0.0
        if not abs(stats["blend_weight_bias"]) <= ORACLE_BLEND_BIAS:
            raise AssertionError(f"oracle {name}: the blended weights are "
                                 f"{stats['blend_weight_bias']} (relative, mean over "
                                 f"{len(bias)} samples) from the oracle's rule")
    stats.setdefault("boundary_edges", {})[method] = edges
    return rows, cols


def oracle_textures(name, scene, near, closest, rays_o, rays_d, params, rows, cols, stats):
    """The texture slots of ORACLE_TEX_SAMPLES samples at a fixed stride:
    under texture_lookup="closest" within ORACLE_TOLS["texture"] of
    Scene.get_parameters (the exact closest point over the whole base
    mesh), or, at a candidate miss (that point's triangle is not among the
    instance's candidates), of the host's closest point over the
    candidates; under the default "jacobian" within the JAX test's mean
    (and, on the smooth checkerboard, its max) of Scene.get_parameters."""
    from nerftex_torch.instancing.scene import (closest_point_on_mesh, closest_point_triangles,
                                                sample_texture)

    pick = np.linspace(0, len(rows) - 1, min(ORACLE_TEX_SAMPLES, len(rows))).astype(int)
    slots = list(scene.texture_parameter_idxs)
    exact, got_c, got_j = [], [], []
    for m in pick:
        r, i = rows[m], cols[m]
        if closest["t"][r, i] != near["t"][r, i]:
            raise AssertionError(f"oracle {name}: the closest-lookup run moved sample ({r}, {i})")
        pt = rays_o[r] + float(near["t"][r, i]) * rays_d[r]
        exact.append(scene.get_parameters(pt, params[r])[slots])
        got_c.append(closest["parameters"][r, i, slots])
        got_j.append(near["parameters"][r, i, slots])
    exact, got_c, got_j = np.asarray(exact), np.asarray(got_c), np.asarray(got_j)
    # The device's closest lookup searches each instance's k nearest base
    # mesh triangles (Scene.instance_tri_candidates, as the JAX package's
    # does); where the exact closest triangle lies outside them, the device
    # is held to the host's closest point over those candidates instead.
    misses = 0
    held = exact.copy()
    err = np.abs(got_c - exact).max(-1)
    for n_m in np.nonzero(err > ORACLE_TOLS["texture"])[0]:
        m = pick[n_m]
        r, i = rows[m], cols[m]
        pt = rays_o[r] + float(near["t"][r, i]) * rays_d[r]
        cand = scene.instance_tri_candidates[closest["instance_id"][r, i]]
        if closest_point_on_mesh(pt, scene.base_mesh)[0] in cand:
            continue
        mesh = scene.base_mesh
        tris = mesh.F[cand]
        points, bary = closest_point_triangles(pt, *(mesh.V[tris[:, k]] for k in range(3)))
        j = int(np.argmin(np.linalg.norm(points - pt, axis=-1)))
        uv = bary[j] @ mesh.UV[tris[j]]
        held[n_m] = [params[r][s] * sample_texture(scene.texture_channels[c], uv[None])[0]
                      for c, s in enumerate(slots)]
        misses += 1
    record_err(stats, "texture", np.abs(got_c - held))
    stats["texture_candidate_misses"] = misses
    stats["texture_max_err_vs_exact"] = float(err.max())
    err_j = np.abs(got_j - exact)
    stats["texture_samples"] = len(pick)
    stats["jacobian_mean_err"] = float(err_j.mean())
    stats["jacobian_max_err"] = float(err_j.max())
    stats["jacobian_past_max"] = int((err_j.max(-1) >= ORACLE_JACOBIAN[1]).sum())
    mean_ok = err_j.mean() < ORACLE_JACOBIAN[0]
    max_ok = err_j.max() < ORACLE_JACOBIAN[1] or name not in ORACLE_JACOBIAN_MAX_SCENES
    if not (mean_ok and max_ok):
        raise AssertionError(f"oracle {name}: the jacobian lookup is {err_j.mean()} (mean), "
                             f"{err_j.max()} (max) from the exact texture, limits "
                             f"{ORACLE_JACOBIAN}")


def shadow_branches() -> dict:
    """How often the shadow query took each exact branch in what the tracer
    recorded (its shadow.skip, shadow.culled and shadow.full counts)."""
    from nerftex_torch.utils import trace

    totals = trace.totals()
    return {k: totals.get(f"shadow.{k}", 0) for k in ("skip", "culled", "full")}


@contextlib.contextmanager
def occlusion_capture(device_instancer):
    """While active, every call of the instance's _occlusion_branched
    appends (points [M, 3], light directions [M, 3], validity [M], blocked
    [M]) on the host to the list it yields."""
    calls = []
    real = device_instancer._occlusion_branched

    def spy(pts, light_dir, pt_valid):
        blocked = real(pts, light_dir, pt_valid)
        shape = pts.shape[:-1]
        calls.append(tuple(x.reshape(-1, *x.shape[len(shape):]).cpu().numpy() for x in (
            pts, light_dir.expand(pts.shape), pt_valid.expand(shape), blocked)))
        return blocked

    device_instancer._occlusion_branched = spy
    try:
        yield calls
    finally:
        del device_instancer._occlusion_branched


def occlusion_margin(scene, pt, d):
    """The largest signed slack over the tests that is_shadowed and the
    device's query share: each instance box's top face (entered from above)
    and bottom face in local coordinates, each front-facing triangle's
    Moller-Trumbore u, v, 1 - u - v and t.  A test passes where its slack
    is positive, so a point whose answer |slack| < ORACLE_EDGE can flip
    is a knife edge."""
    from nerftex_torch.instancing import oracle

    best = -np.inf
    d = np.asarray(d, np.float32)
    if scene.n_instances():
        inv = np.asarray(scene.inverse, np.float32).reshape(-1, 4, 4)
        o_l = inv[:, :3, :3] @ pt + inv[:, :3, 3]
        d_l = inv[:, :3, :3] @ d
        with np.errstate(divide="ignore", invalid="ignore"):
            for z_plane, is_top in ((scene.b_1[2], True), (scene.b_0[2], False)):
                t = (z_plane - o_l[:, 2]) / d_l[:, 2]
                p = o_l + t[:, None] * d_l
                slack = np.stack([t, oracle.T_FAR - t, p[:, 0] - scene.b_0[0],
                                  scene.b_1[0] - p[:, 0], p[:, 1] - scene.b_0[1],
                                  scene.b_1[1] - p[:, 1]] + ([-d_l[:, 2]] if is_top else []), -1)
                best = max(best, float(np.nan_to_num(slack.min(-1), nan=-np.inf).max()))
    for mesh in ([scene.base_mesh] if scene.base_mesh is not None else []) + scene.aux_meshes:
        v0 = mesh.V[mesh.F[:, 0]]
        e1 = mesh.V[mesh.F[:, 1]] - v0
        e2 = mesh.V[mesh.F[:, 2]] - v0
        front = np.cross(e1, e2) @ d < 0
        pvec = np.cross(d, e2)
        with np.errstate(divide="ignore", invalid="ignore"):
            inv_det = 1.0 / np.sum(e1 * pvec, -1)
            tvec = pt - v0
            u = np.sum(tvec * pvec, -1) * inv_det
            qvec = np.cross(tvec, e1)
            v = np.sum(d * qvec, -1) * inv_det
            t = np.sum(e2 * qvec, -1) * inv_det
        slack = np.stack([u, v, 1 - u - v, t - 1e-6], -1).min(-1)
        slack = np.where(front, np.nan_to_num(slack, nan=-np.inf), -np.inf)
        best = max(best, float(slack.max()) if len(slack) else -np.inf)
    return best


def oracle_occlusion(name, scene, calls, stats):
    """The device's blocked flags at its own shadow points against
    oracle.is_shadowed at the same points and light directions; every
    differing point must be a knife edge (occlusion_margin)."""
    from nerftex_torch.instancing import oracle

    n = edges = 0
    for pts, light, valid, blocked in calls:
        for m in np.nonzero(valid)[0]:
            n += 1
            want = oracle.is_shadowed(scene, pts[m], light[m])
            if bool(blocked[m]) == want:
                continue
            margin = occlusion_margin(scene, pts[m], light[m])
            if not abs(margin) < ORACLE_EDGE:
                raise AssertionError(f"oracle {name}: shadow point {pts[m].tolist()} toward "
                                     f"{light[m].tolist()}: device blocked {bool(blocked[m])}, "
                                     f"oracle {want}, deciding slack {margin}")
            edges += 1
    if n == 0:
        raise AssertionError(f"oracle {name}: no shadow point was captured")
    stats["shadow_points"] = n
    stats["shadow_knife_edges"] = edges
    stats["shadow_blocked"] = int(sum(b[v].sum() for _, _, v, b in calls))


def oracle_run(instancer, rays_o, rays_d, params, n_samples, step):
    """DeviceInstancer.get_model_input on the instancer's device, as numpy."""
    from nerftex_torch.utils import jax_rng

    out = instancer.get_model_input(rays_o, rays_d, params, n_samples, step,
                                    key=jax_rng.key(ORACLE_KEY))
    return {k: v.cpu().numpy() for k, v in out.items() if not k.startswith("overflow")}


def oracle_scene(name, cfg, rays, n_samples, step, methods, device, counts, stats):
    """One shipped scene against the oracle: the Instancer built from the
    config (deterministic offsets, so that the oracle samples the same arc
    positions), ORACLE_RAYS' rays, the device run under each of
    ``methods`` (the scene's own first) and, with a texture channel, under
    texture_lookup="closest"; shadows at the device's shadow points."""
    from nerftex_torch.instancing import oracle
    from nerftex_torch.instancing.device import DeviceInstancer
    from nerftex_torch.utils import trace
    from nerftex_torch.utils.util import instantiate

    t0 = time.perf_counter()
    inst = instantiate(dict(cfg, deterministic_offset=True, matmul_precision="float32",
                            device=device))
    scene, dev = inst.scene, inst.device_instancer
    stats.update(scene=name, instances=scene.n_instances(), max_err={})
    n_hit, n_miss = ORACLE_RAYS[name]
    idx, geom, stride = oracle_pick_rays(scene, rays["rays_o"], rays["rays_d"], n_hit, n_miss)
    rays_o, rays_d = rays["rays_o"][idx], rays["rays_d"][idx]
    params = np.repeat(rays["parameters"], len(idx), 0)
    stats.update(hit_rays=n_hit, missing_rays=n_miss, of_frame=len(rays["rays_o"]),
                 ray_stride=stride)
    S = min(n_samples, dev.max_steps_per_ray)
    stats["host_s"] = time.perf_counter() - t0

    kw = dict(max_hits=dev.max_hits, ray_block=dev.ray_block,
              max_steps_per_ray=dev.max_steps_per_ray, cull_budget=dev.cull_budget,
              tri_cull_budget=dev.tri_cull_budget, shadow_samples=dev.shadow_samples,
              shadow_cull_budget=dev.shadow_cull_budget,
              shadow_tri_cull_budget=dev.shadow_tri_cull_budget, deterministic_offset=True)
    outs, calls = {}, []
    t0 = time.perf_counter()
    for method in methods:
        if method == scene.instance_sampling_method:
            d = dev
        else:
            other = copy.copy(scene)
            other.instance_sampling_method = method
            d = DeviceInstancer(other, torch.device(device), **kw)
        trace.reset()
        with occlusion_capture(d) as got, trace.recording():
            outs[method] = oracle_run(d, rays_o, rays_d, params, n_samples, step)
        if method == scene.instance_sampling_method:
            calls = got
            stats["shadow_branches"] = shadow_branches()
    if scene.texture_parameter_idxs:
        closest = DeviceInstancer(scene, torch.device(device), texture_lookup="closest", **kw)
        outs["closest"] = oracle_run(closest, rays_o, rays_d, params, n_samples, step)
    stats["device_s"] = time.perf_counter() - t0
    if counts is not None:
        launches = counts[1]()[0]
        stats["launches"] = {k: launches[k] for k in ("per_ray", "selk_resolve", "tex_fetch",
                                                      "shadow_query")}
        oracle_launches(name, launches, bool(scene.texture_parameter_idxs),
                        bool(scene.cast_shadow_rays))

    t0 = time.perf_counter()
    orc = oracle.get_model_input(oracle_scene_view(scene), rays_o, rays_d, params, S, step,
                                 FixedOffsets(ORACLE_KEY))
    stats["oracle_s"] = time.perf_counter() - t0
    stats["terminated_rays"] = int(orc["alpha_last"].sum())
    t0 = time.perf_counter()
    for method in methods:
        n = oracle_per_ray(name, outs[method], orc, step, stats)
        rows, cols = oracle_picks(name, scene, outs[method], orc, geom, rays_o, rays_d, n,
                                  method, stats)
        if method == "nearest" and scene.light_strength_idx >= 0:
            si = scene.light_strength_idx
            got = outs[method]["parameters"][rows, cols, si]
            want = orc["parameters"][rows, cols, si]
            record_err(stats, "point_light", np.abs(got - want) / np.abs(want))
    if "closest" in outs:
        n = oracle_per_ray(name, outs["closest"], orc, step, stats)
        rows, cols = np.nonzero(np.arange(S)[None, :] < n[:, None])
        oracle_textures(name, scene, outs[methods[0]], outs["closest"], rays_o, rays_d, params,
                        rows, cols, stats)
    if scene.cast_shadow_rays:
        oracle_occlusion(name, scene, calls, stats)
    stats["check_s"] = time.perf_counter() - t0


def oracle_launches(name, launches, textured, shadowed):
    """per_ray and selk_resolve launched, tex_fetch exactly where the scene
    has a parameter texture and shadow_query exactly where it casts shadow
    rays."""
    for kernel in ("per_ray", "selk_resolve"):
        if launches[kernel] <= 0:
            raise AssertionError(f"oracle {name}: {kernel} was not launched")
    if textured != (launches["tex_fetch"] > 0):
        raise AssertionError(f"oracle {name}: tex_fetch launched {launches['tex_fetch']} "
                             f"times with{'' if textured else 'out'} a parameter texture")
    if shadowed != (launches["shadow_query"] > 0):
        raise AssertionError(f"oracle {name}: shadow_query launched "
                             f"{launches['shadow_query']} times with{'' if shadowed else 'out'} "
                             f"shadow rays")


def oracle_aux_scene(device, counts, stats):
    """tests/test_device_instancer.py's auxiliary-mesh scene (no shipped
    config sets auxiliary_meshes): one box, a far base mesh, and the cloth
    mesh lowered by 2 with checkerboard.png; color_last and alpha_last
    against the oracle's at that test's limits, the frame shaded."""
    from nerftex_torch.instancing import oracle
    from nerftex_torch.instancing.device import DeviceInstancer
    from nerftex_torch.instancing.scene import Scene, SceneMesh

    scene = Scene(b_0=[-0.5, -0.5, -0.5], b_1=[0.5, 0.5, 0.5], textures=["light"])
    scene.add_instance(np.eye(4, dtype=np.float32))
    scene.base_mesh = SceneMesh(
        np.array([[-9, -9, -9], [9, -9, -9], [9, 9, -9], [-9, 9, -9]], np.float32),
        np.array([[0, 1, 2], [0, 2, 3]], np.int32))
    scene.add_mesh(os.path.join(ROOT, "meshes", "cloth_mesh.ply"),
                   os.path.join(ROOT, "meshes", "checkerboard.png"))
    scene.aux_meshes[0].V[:, 2] -= 2.0
    rays_o = np.array([[0.1, 0.05, 5.0], [-0.2, 0.1, 5.0]], np.float32)
    rays_d = np.tile(np.array([0, 0, -1.0], np.float32), (2, 1))
    params = np.tile(np.array([0, 0, 1.0], np.float32), (2, 1))
    dev = DeviceInstancer(scene, torch.device(device), max_hits=4, ray_block=2,
                          deterministic_offset=True)
    out = oracle_run(dev, rays_o, rays_d, params, 32, 0.1)
    if counts is not None:
        launches = counts[1]()[0]
        stats["launches"] = {k: launches[k] for k in ("per_ray", "selk_resolve", "tex_fetch",
                                                      "shadow_query")}
        oracle_launches("aux", launches, False, False)
    orc = oracle.get_model_input(scene, rays_o, rays_d, params, 32, 0.1,
                                 FixedOffsets(ORACLE_KEY))
    stats.update(scene="aux", instances=1, rays=2, max_err={})
    oracle_per_ray("aux", out, orc, 0.1, stats)
    stats["color_last_max"] = float(out["color_last"].max())
    if not stats["color_last_max"] > ORACLE_AUX_SHADED:
        raise AssertionError(f"oracle aux: the terminator is not shaded "
                             f"(color_last max {stats['color_last_max']})")


def main_oracle(counts, card, device="cuda"):
    """Phase 17 (module docstring): the bench, plush and grass scenes at
    their shipped settings and the auxiliary-mesh scene, each device run
    held against nerftex_torch/instancing/oracle.py on the host.  Returns
    the per-scene numbers."""
    from nerftex_torch.ops.rays import frame_rays

    t_phase = time.perf_counter()
    bench_rays = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                            [1, 1, 1, 0.1, 0, 0, 1.0])
    scenes = (
        ("bench", renderer_config("float32"), bench_rays,
         ("nearest", "random", "nearest_blend")),
        ("plush", plush_renderer_config(), scene_data("plush")[0],
         ("nearest_blend", "nearest", "random")),
        ("grass", grass_renderer_config(), scene_data("grass")[0], ("nearest",)),
    )
    numbers = {}
    for name, render_cfg, data, methods in scenes:
        rays = {"rays_o": data["rays_o"][0], "rays_d": data["rays_d"][0],
                "parameters": data["parameters"]}
        stats = {}
        if counts is not None:
            counts[0]()
        t0 = time.perf_counter()
        oracle_scene(name, render_cfg["instancer_config"], rays, render_cfg["n_samples"],
                     render_cfg["step_size"], methods, device, counts, stats)
        stats["seconds"] = time.perf_counter() - t0
        if name == "grass" and not stats["terminated_rays"]:
            raise AssertionError("oracle grass: no ray ends on the terrain")
        log(f"oracle {name}: {json.dumps(stats)}")
        numbers[name] = stats
    stats = {}
    if counts is not None:
        counts[0]()
    t0 = time.perf_counter()
    oracle_aux_scene(device, counts, stats)
    stats["seconds"] = time.perf_counter() - t0
    log(f"oracle aux: {json.dumps(stats)}")
    numbers["aux"] = stats
    seconds = time.perf_counter() - t_phase
    log(f"oracle phase: {seconds:.1f} s (budget {ORACLE_BUDGET_S} s) on {card}")
    numbers["seconds"] = seconds
    return numbers


def shadow_block_capture(name, render_cfg):
    """The shadow query's arguments in one ray block of the scene's frame
    whose swept-cone candidates fit the shadow budgets (the culled branch):
    the first such block from the middle of the frame outward, run through
    DeviceInstancer._per_ray on the card with nerftex_torch.instancing.
    device.shadow_query spied on."""
    from nerftex_torch.instancing import device as device_module
    from nerftex_torch.utils.util import instantiate

    cfg = render_cfg["instancer_config"]
    dev = instantiate(dict(cfg, device="cuda")).device_instancer
    data = scene_data(name)[0]
    rays_o, rays_d = (torch.tensor(data[k][0], device="cuda") for k in ("rays_o", "rays_d"))
    rb, n = dev.ray_block, rays_o.shape[0]
    params = torch.tensor(np.repeat(data["parameters"], rb, 0), device="cuda")
    u_off = torch.full((rb,), 0.5, device="cuda")
    S = min(render_cfg["n_samples"], dev.max_steps_per_ray)
    mid = n // rb // 2
    calls = []
    real = device_module.shadow_query

    def spy(*args):
        calls.append(args)
        return real(*args)

    device_module.shadow_query = spy
    try:
        for b in sorted(range(n // rb), key=lambda b: abs(b - mid)):
            calls.clear()
            dev._per_ray(rays_o[b * rb:(b + 1) * rb], rays_d[b * rb:(b + 1) * rb], params, S,
                         render_cfg["step_size"], u_off)
            if calls and calls[0][5] is not None:
                return b, calls[0]
    finally:
        device_module.shadow_query = real
    raise AssertionError(f"shadow_query {name}: no ray block took the culled branch")


def shadow_query_work(args, plane=1 << 20):
    """(float operations, blocked [M]) of the kernel's own walk over one
    query: each point's tests in its order (boxes, then triangles, each in
    candidate order, a padding column as zeros) up to and including its
    first blocking column, each test counted to the exit it takes
    (SHADOW_BOX_STEPS, SHADOW_TRI_STEPS).  The tests are the plain chain's
    operations in the kernel's order and rounding, so every exit is the
    kernel's.  Computed in chunks of points of at most ``plane`` pairs."""
    from nerftex_torch.instancing.geometry import T_FAR

    pts, light, (inv_rot, inv_trans), tris, (b_0, b_1), inst_sel, tri_sel = args

    def columns(tables, sel):
        if sel is None:
            return tables
        ids, valid = sel
        return tuple(torch.where(valid.reshape(-1, *(1,) * (x.dim() - 1)), x[ids], 0.0)
                     for x in tables)

    rot, trans = columns((inv_rot, inv_trans), inst_sel)
    tri = None if tris is None else columns(tris, tri_sel)
    n = rot.shape[0] + (0 if tri is None else tri[0].shape[0])
    if n == 0:
        return 0, torch.zeros(pts.shape[0], dtype=torch.bool, device=pts.device)

    def dot(a, b):
        """(a0 b0 + a1 b1) + a2 b2 over [m, 1] x [N] -> [m, N]."""
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    box_steps, face_ops, tri_steps = SHADOW_BOX_STEPS, SHADOW_FACE_OPS, SHADOW_TRI_STEPS
    ops, blocked = 0, []
    step = max(1, plane // n)
    for i in range(0, pts.shape[0], step):
        p = pts[i:i + step].T[:, :, None]
        l = light[i:i + step].T[:, :, None]
        cost, hit = [], []
        if rot.shape[0]:
            r = rot.permute(1, 2, 0)                                   # [3 rows, 3, N]
            dz = dot(l, r[2])
            live = dz.abs() > 1e-12
            oz = dot(p, r[2]) + trans[:, 2]
            n_top, n_bot = b_1[2] - oz, b_0[2] - oz
            top = (dz < 0) & (n_top < 0)
            bot = torch.where(dz > 0, n_bot > 0, n_bot < 0)
            ox, oy = dot(p, r[0]) + trans[:, 0], dot(p, r[1]) + trans[:, 1]
            dx, dy = dot(l, r[0]), dot(l, r[1])

            def face(num):
                t = num / dz
                inside = (t > 0) & (t < T_FAR)
                x, y = ox + t * dx, oy + t * dy
                return inside, inside & (x >= b_0[0]) & (x <= b_1[0]) & (y >= b_0[1]) & (
                    y <= b_1[1])

            in_top, hit_top = face(n_top)
            in_bot, hit_bot = face(n_bot)
            top_hit = top & hit_top
            bot_tried = bot & ~top_hit
            faces = (top * (face_ops[0] + face_ops[1] * in_top)
                     + bot_tried * (face_ops[0] + face_ops[1] * in_bot))
            cost.append(box_steps[0] + live * (box_steps[1] + (top | bot) * (box_steps[2]
                                                                             + faces)))
            hit.append(live & (top_hit | (bot_tried & hit_bot)))
        if tri is not None and tri[0].shape[0]:
            v0, e1, e2, ng = (x.T for x in tri)                         # [3, N] each
            front = dot(l, ng) < 0
            pv = (l[1] * e2[2] - l[2] * e2[1], l[2] * e2[0] - l[0] * e2[2],
                  l[0] * e2[1] - l[1] * e2[0])
            det = dot(e1, pv)
            det_ok = det.abs() > 1e-12
            inv = 1.0 / det
            tv = (p[0] - v0[0], p[1] - v0[1], p[2] - v0[2])
            u = dot(tv, pv) * inv
            q = (tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
                 tv[0] * e1[1] - tv[1] * e1[0])
            v = dot(l, q) * inv
            uv_ok = u + v <= 1
            t = dot(e2, q) * inv
            u_ok, v_ok = u >= 0, v >= 0
            s0, s1, s2, s3, s4, s5 = tri_steps
            cost.append(s0 + front * (s1 + det_ok * (s2 + u_ok * (s3 + v_ok * (
                s4 + uv_ok * s5)))))
            hit.append(front & det_ok & u_ok & v_ok & uv_ok & (t > 1e-6) & (t < T_FAR))
        cost, hit = torch.cat(cost, 1), torch.cat(hit, 1)
        any_hit = hit.any(1)
        first = torch.where(any_hit, hit.to(torch.uint8).argmax(1), n - 1)
        walked = torch.arange(n, device=pts.device)[None, :] <= first[:, None]
        ops += int((cost * walked).sum())
        blocked.append(any_hit)
    return ops, torch.cat(blocked)


def shadow_query_bound(args):
    """(least ms, operations, bytes) of one query: the float operations of
    the kernel's own walk (shadow_query_work: each test to its exit, each
    point to its first blocking column) over the f32 pipes' unfused rate,
    against the points, directions, flags and gathered columns over HBM's
    bandwidth; and the walk's blocked flags.  No run of the kernel can beat
    it: warps that diverge, loads, the barriers and the division's
    instructions beyond one are not counted."""
    pts, _, boxes, tris, _, inst_sel, tri_sel = args
    m = pts.shape[0]
    n_box = boxes[0].shape[0] if inst_sel is None else inst_sel[0].shape[0]
    n_tri = 0 if tris is None else tris[0].shape[0] if tri_sel is None else tri_sel[0].shape[0]
    ops, blocked = shadow_query_work(args)
    id_bytes = 9 * (n_box * (inst_sel is not None) + n_tri * (tri_sel is not None))
    nbytes = m * (12 + 12 + 1) + 48 * (n_box + n_tri) + id_bytes + 24
    return max(ops / H100_F32_OPS, nbytes / H100_BYTES_PER_S) * 1e3, ops, nbytes, blocked


def main_shadow_query(card):
    """Phase 18 (module docstring): the shadow query kernel against its plain
    chain, bit for bit, on a full grass and a full plush ray block in the
    culled and the full branch, each timed (kernel calls replayed from a
    CUDA graph, the plain chain by events) beside its bound.  Returns
    {scene: {branch: row}}."""
    from nerftex_torch.kernels import shadow_query as sq

    t_phase = time.perf_counter()
    rows = {}
    for name, render_cfg in (("grass", grass_renderer_config()),
                             ("plush", plush_renderer_config())):
        block, culled = shadow_block_capture(name, render_cfg)
        rows[name] = {}
        for branch in ("culled", "full"):
            args = culled if branch == "culled" else culled[:5] + (None, None)
            before = sq.shadow_query.launches
            got = sq.shadow_query(*args)
            want = sq.shadow_query_plain(*args)
            if sq.shadow_query.launches != before + 1:
                raise AssertionError(f"shadow_query {name} {branch}: the kernel did not launch")
            if not torch.equal(got, want):
                raise AssertionError(f"shadow_query {name} {branch}: the kernel differs from the "
                                     f"plain chain at {int((got != want).sum())} of "
                                     f"{got.numel()} points")
            bound, ops, nbytes, walked = shadow_query_bound(args)
            if not torch.equal(walked, want):
                raise AssertionError(f"shadow_query {name} {branch}: the bound's walk blocks "
                                     f"{int(walked.sum())} points, the plain chain "
                                     f"{int(want.sum())}")
            row = {"block": block, "points": int(got.numel()),
                   "boxes": int((args[2][0] if args[5] is None else args[5][0]).shape[0]),
                   "triangles": 0 if args[3] is None else int(
                       (args[3][0] if args[6] is None else args[6][0]).shape[0]),
                   "blocked": float(got.float().mean()),
                   "device_ms": device_ms(lambda: sq.shadow_query(*args), SHADOW_TIMED_CALLS),
                   "plain_ms": time_ms(lambda: sq.shadow_query_plain(*args), iters=3, warmup=1),
                   "bound_ms": bound, "ops": ops, "bytes": nbytes}
            row["share_of_bound"] = row["bound_ms"] / row["device_ms"]
            if not row["share_of_bound"] <= 1.0:
                raise AssertionError(f"shadow_query {name} {branch}: {row['device_ms']} ms beats "
                                     f"its bound of {bound} ms")
            log(f"shadow_query {name} {branch}: {json.dumps(row)}")
            rows[name][branch] = row
    log(f"phase shadow query: {time.perf_counter() - t_phase:.1f} s on {card}")
    return rows


def per_ray_setup(name, device="cuda"):
    """The per-ray stage's inputs in the scene's frame: (DeviceInstancer on
    the card, rays_o, rays_d [R, 3], parameters [R, P], S, step).  carpet:
    config_carpet_render's first dataset item at the carpet operating point
    with bf16 dots (carpet_frame's); grass and plush: their golden frames'
    rays and flags."""
    from nerftex_torch.utils.util import instantiate

    if name == "carpet":
        data = config_item("carpet")[0]
        render_cfg = carpet_configs("carpet")[1]
    else:
        data = scene_data(name)[0]
        render_cfg = grass_renderer_config() if name == "grass" else plush_renderer_config()
    dev = instantiate(dict(render_cfg["instancer_config"], device=device)).device_instancer

    def rows(x, width):
        x = x.cpu() if isinstance(x, torch.Tensor) else np.asarray(x)
        return torch.as_tensor(x, dtype=torch.float32).reshape(-1, width).to(device).contiguous()

    rays_o, rays_d = rows(data["rays_o"], 3), rows(data["rays_d"], 3)
    params = rows(data["parameters"], np.asarray(data["parameters"]).shape[-1])
    if params.shape[0] == 1:
        params = params.expand(rays_o.shape[0], -1).contiguous()
    S = min(render_cfg["n_samples"], dev.max_steps_per_ray)
    return dev, rays_o, rays_d, params, S, render_cfg["step_size"]


def per_ray_args(dev, rays_o, rays_d, S, step, culled=True):
    """kernels.per_ray's arguments for these rays (offsets 0.5) at the
    instancer's settings; culled False turns both culls off."""
    ds = dev.ds
    u_off = torch.full((rays_o.shape[0],), 0.5, device=rays_o.device)
    budgets = (dev.cull_budget, dev.tri_cull_budget) if culled else (0, 0)
    return (ds, rays_o, rays_d, u_off, min(dev.max_hits, ds.n_instances), S, step, *budgets,
            dev.matmul_precision)


def per_ray_hit_columns(args):
    """(instances, triangles) that the full branch needs for the block, as
    sorted id arrays: each box that gives some ray a valid interval (clipped
    at the ray's first mesh hit) and each triangle that is some ray's first
    hit; the slab test's operands rounded as the block's matmul_precision
    rounds them."""
    from nerftex_torch.instancing.geometry import T_FAR, moller_trumbore
    from nerftex_torch.models.encodings import round_operand

    ds, o, d, _, _, _, _, _, _, prec = args
    t_mesh = torch.full((o.shape[0],), float("inf"), device=o.device)
    tris = torch.zeros(0, dtype=torch.int64, device=o.device)
    if ds.n_tris:
        t_mesh, best = moller_trumbore(o, d, ds.tri_v0, ds.tri_e1, ds.tri_e2)[0].min(-1)
        tris = best[torch.isfinite(t_mesh)].unique()
    t0 = torch.full((o.shape[0], ds.n_instances), -float("inf"), device=o.device)
    t1 = -t0
    o_r, d_r = round_operand(o, prec), round_operand(d, prec)
    for c in range(3):
        rot_c = round_operand(ds.inv_rot[:, c, :].T, prec)
        o_lc = o_r @ rot_c + ds.inv_trans[:, c]
        inv = 1.0 / torch.where((d_r @ rot_c).abs() < 1e-12, 1e-12, d_r @ rot_c)
        t_a, t_b = (ds.b_0[c] - o_lc) * inv, (ds.b_1[c] - o_lc) * inv
        t0 = torch.maximum(t0, torch.minimum(t_a, t_b))
        t1 = torch.minimum(t1, torch.maximum(t_a, t_b))
    t1c = torch.minimum(torch.clamp(t1, 0.0, T_FAR), t_mesh[:, None])
    valid = (t0 < t1) & (t1 > 0) & (t0 < T_FAR) & (torch.clamp(t0, 0.0, T_FAR) < t1c)
    return valid.any(0).nonzero()[:, 0].cpu().numpy(), tris.cpu().numpy()


def per_ray_keep_sets(args, got):
    """The kernels' cull buffer of one block: {kind: (count, budget, kept
    ids or None where the set does not fit)}; each kept set ascending and,
    where it fits, holding every column that per_ray_hit_columns finds
    (raise otherwise)."""
    from nerftex_torch.kernels.per_ray import budgets

    ds, _, _, _, K, _, _, cull_budget, tri_cull_budget, _ = args
    C, TC = budgets(ds, K, cull_budget, tri_cull_budget)
    if got["cull"] is None:
        return {}
    cull = got["cull"].cpu().numpy()
    hits = per_ray_hit_columns(args)
    out = {}
    for i, (kind, budget, start, hit) in enumerate((("instances", C, 4, hits[0]),
                                                     ("triangles", TC, 4 + C, hits[1]))):
        if not budget:
            continue
        count = int(cull[i])
        kept = cull[start:start + count] if count <= budget else None
        if kept is not None:
            if not (np.diff(kept) > 0).all():
                raise AssertionError(f"per_ray: the kept {kind} are not ascending")
            missed = np.setdiff1d(hit, kept)
            if missed.size:
                raise AssertionError(f"per_ray: the {kind} keep set misses hit columns "
                                     f"{missed[:10].tolist()} ({missed.size})")
        out[kind] = (count, budget, kept)
    if int(cull[2]) + int(cull[3]) != len(out) or int(cull[2]) != sum(
            v[2] is not None for v in out.values()):
        raise AssertionError(f"per_ray: cull counts {cull[2:4].tolist()} for sets {out}")
    return out


def per_ray_discrete(t, S, step, exact=False):
    """The discrete per-ray outputs of per_ray's result ``t`` as [R, ...]
    tensors: hit slots' validity and ids (-1 in invalid slots, whose
    contents no pick reads), n_steps, tiny, hit, the arc's whole steps
    floor(total / step), the mesh's hit and triangle.  The quotient is the
    correctly rounded one (the kernels' and the CPU's) with ``exact``,
    else the one PyTorch computes on the tables' device (the chain's: a
    card's division by a host scalar can differ in the last bit)."""
    total = t["total"]
    necessary = (torch.floor(total.cpu() / step).to(total.device) if exact
                 else torch.floor(total / step))
    mesh = torch.isfinite(t["t_mesh"])
    out = {"kvalid": t["kvalid"], "inst_idx": torch.where(t["kvalid"], t["inst_idx"], -1),
           "n_steps": t["n_steps"],
           "tiny": t["tiny"], "hit": t["hit"], "necessary": necessary.long(), "mesh_hit": mesh}
    if t["tri"] is not None:
        out["tri"] = torch.where(mesh, t["tri"], -1)
    return out


def per_ray_rows_differ(a, b):
    """[R] True where any discrete output of a and b differs."""
    diff = None
    for k, x in a.items():
        y = b[k].to(x.device)
        d = (x != y).reshape(x.shape[0], -1).any(1)
        diff = d if diff is None else diff | d
    return diff


def per_ray_knife_edges(args, rows):
    """Of the rays ``rows`` (indices into the block), those on a knife edge:
    the float64 chain's discrete outputs (culls off, on the host) change
    when the ray's origin or direction moves by PER_RAY_EDGE_RAY or every
    box's translation by PER_RAY_EDGE_BOX, along an axis either way."""
    import types

    from nerftex_torch.kernels.per_ray import per_ray_plain

    ds, o, d, u_off, K, S, step, _, _, prec = args
    names = ("inv_rot", "inv_trans", "origins", "b_0", "b_1") + (
        ("tri_v0", "tri_e1", "tri_e2") if ds.n_tris else ())
    tables = {k: getattr(ds, k).double().cpu() for k in names}
    idx = torch.as_tensor(rows, dtype=torch.int64, device=o.device)
    o64, d64, u64 = (x[idx].double().cpu() for x in (o, d, u_off))

    def discrete(o_, d_, trans=None):
        scene = types.SimpleNamespace(n_instances=ds.n_instances, n_tris=ds.n_tris,
                                      **dict(tables, inv_trans=tables["inv_trans"]
                                             if trans is None else trans))
        return per_ray_discrete(per_ray_plain(scene, o_, d_, u64, K, S, step, 0, 0, prec), S,
                                step)

    base = discrete(o64, d64)
    moved = torch.zeros(len(rows), dtype=torch.bool)
    scale_o = o64.abs().clamp(min=1.0)
    trans = tables["inv_trans"]
    for axis in range(3):
        for sign in (1.0, -1.0):
            e = torch.zeros(3, dtype=torch.float64)
            e[axis] = sign
            moved |= per_ray_rows_differ(discrete(o64 + PER_RAY_EDGE_RAY * scale_o * e, d64),
                                         base)
            moved |= per_ray_rows_differ(discrete(o64, d64 + PER_RAY_EDGE_RAY * e), base)
            shifted = trans + PER_RAY_EDGE_BOX * (1.0 + trans.abs()) * e
            moved |= per_ray_rows_differ(discrete(o64, d64, shifted), base)
    return moved.numpy()


def compare_per_ray(args, got, want):
    """The kernels' result ``got`` against the plain chain's ``want`` on one
    block: every discrete output equal but on rays that per_ray_knife_edges
    finds on a knife edge (raise on any other; on more than 1 % of the
    block at all), the float tables of the other rays within
    PER_RAY_FLOAT_TOL x their largest |value| and infinite in the same
    places (the anchor terms in the valid slots), the drop counts equal
    (or, with knife edges, each consistent with its own tables).  Returns (knife-edge rays, largest float error
    over its table's scale)."""
    _, _, _, _, K, S, step, _, _, _ = args
    dg, dw = per_ray_discrete(got, S, step, exact=True), per_ray_discrete(want, S, step)
    if set(dg) != set(dw):
        raise AssertionError(f"per_ray: outputs {sorted(dg)} against {sorted(dw)}")
    differ = per_ray_rows_differ(dg, dw).cpu().numpy()
    rows = np.nonzero(differ)[0]
    if len(rows) > max(2, differ.size // 100):
        raise AssertionError(f"per_ray: {len(rows)} of {differ.size} rays differ, e.g. "
                             f"{rows[:10].tolist()}")
    if len(rows):
        edge = per_ray_knife_edges(args, rows)
        if not edge.all():
            raise AssertionError(f"per_ray: rays {rows[~edge].tolist()} differ from the plain "
                                 f"chain and sit on no knife edge")
    same = torch.as_tensor(~differ, device=got["tk0"].device)
    mesh = torch.isfinite(want["t_mesh"])
    worst = 0.0
    for k in ("tk0", "tk1", "sel_a", "sel_b", "times_s", "cum_incl", "cum_excl", "arc_corr",
              "total", "t_offset", "t_mesh", "tri_u", "tri_v", "alpha_last", "color_last"):
        if want[k] is None:
            continue
        g, w = got[k], want[k]
        mask = same[:, None] & want["kvalid"] if k in ("sel_a", "sel_b") else (
            same & mesh if k in ("tri_u", "tri_v") else same)
        g, w = g[mask], w[mask]
        fin = torch.isfinite(w)
        if not torch.equal(torch.isfinite(g), fin) or not torch.equal(g[~fin], w[~fin]):
            raise AssertionError(f"per_ray: {k} is infinite in other places")
        if fin.any():
            scale = max(float(w[fin].abs().max()), 1e-30)
            err = float((g[fin] - w[fin]).abs().max()) / scale
            worst = max(worst, err)
            if not err <= PER_RAY_FLOAT_TOL:
                raise AssertionError(f"per_ray: {k} differs by {err:.3g} of its scale")
    for k, name in (("overflow_hits", "hits"), ("overflow_steps", "steps")):
        g, w = int(got[k]), int(want[k])
        if k == "overflow_steps":
            for side, t, n in (("kernels", dg, g), ("plain", dw, w)):
                if int(torch.clamp(t["necessary"] - S, min=0).sum()) != n:
                    raise AssertionError(f"per_ray: the {side}' dropped steps {n} are not "
                                         f"their rays' own")
        if g != w and not len(rows):
            raise AssertionError(f"per_ray: dropped {name} {g} against the plain chain's {w}")
    return rows.tolist(), worst


def per_ray_walked(args, got):
    """The columns the kernels walked on one block: (instance ids or None
    for every instance, triangle ids or None for every triangle; on the
    device), from its cull buffer (a fitting keep set: its ids)."""
    from nerftex_torch.kernels.per_ray import budgets

    ds, o, _, _, K, _, _, cull_budget, tri_cull_budget, _ = args
    C, TC = budgets(ds, K, cull_budget, tri_cull_budget)
    cull = None if got["cull"] is None else got["cull"].cpu().numpy()

    def walked(budget, start, count_at):
        if cull is not None and budget and cull[count_at] <= budget:
            return torch.as_tensor(cull[start:start + cull[count_at]], dtype=torch.int64,
                                   device=o.device)
        return None

    return walked(C, 4, 0), walked(TC, 4 + C, 1) if ds.n_tris else None


def per_ray_work(args, got):
    """Float operations of the kernels' own walk over one block (the
    PER_RAY_* counts): each triangle test to its exit and each box's slab
    test over the columns the kernel walked (the candidates where a keep
    set fit, padding skipped), the anchor terms of every hit slot, the
    events of the kept intervals, and, with a cull, the fan over the rays
    and every sphere's keep test (the instance spheres' pads with bfloat16
    operands)."""
    from nerftex_torch.kernels.per_ray import budgets, inst_pad

    ds, o, d, _, K, _, _, _, _, prec = args
    rb = o.shape[0]
    C, TC = budgets(ds, K, args[7], args[8])
    boxes, tris = per_ray_walked(args, got)
    n_box = ds.n_instances if boxes is None else int(boxes.numel())
    ops = rb * n_box * PER_RAY_BOX_OPS + rb * K * PER_RAY_SLOT_OPS
    ops += int(got["kvalid"].sum()) * 2 * PER_RAY_EVENT_OPS
    if ds.n_tris:
        v0, e1, e2 = ((ds.tri_v0, ds.tri_e1, ds.tri_e2) if tris is None else
                      (ds.tri_v0[tris], ds.tri_e1[tris], ds.tri_e2[tris]))
        s0, s1, s2, s3, s4 = PER_RAY_TRI_STEPS
        for i in range(0, rb, 256):
            oo, dd = o[i:i + 256, :, None], d[i:i + 256, :, None]
            pv = (dd[:, 1] * e2[:, 2] - dd[:, 2] * e2[:, 1], dd[:, 2] * e2[:, 0] -
                  dd[:, 0] * e2[:, 2], dd[:, 0] * e2[:, 1] - dd[:, 1] * e2[:, 0])
            det = e1[:, 0] * pv[0] + e1[:, 1] * pv[1] + e1[:, 2] * pv[2]
            inv = 1.0 / det
            tv = (oo[:, 0] - v0[:, 0], oo[:, 1] - v0[:, 1], oo[:, 2] - v0[:, 2])
            u = (tv[0] * pv[0] + tv[1] * pv[1] + tv[2] * pv[2]) * inv
            q = (tv[1] * e1[:, 2] - tv[2] * e1[:, 1], tv[2] * e1[:, 0] - tv[0] * e1[:, 2],
                 tv[0] * e1[:, 1] - tv[1] * e1[:, 0])
            v = (dd[:, 0] * q[0] + dd[:, 1] * q[1] + dd[:, 2] * q[2]) * inv
            det_ok, u_ok, v_ok = det.abs() > 1e-12, u >= 0, v >= 0
            ops += int((s0 + det_ok * (s1 + u_ok * (s2 + v_ok * (s3 + (u + v <= 1) * s4))))
                       .sum())
    if got["cull"] is not None:
        n_inst = ds.n_instances if C else 0
        ops += rb * PER_RAY_FAN_RAY_OPS + PER_RAY_FAN_SPHERE_OPS * (
            n_inst + (ds.n_tris if TC else 0))
        if inst_pad(ds, C, prec) is not None:
            ops += PER_RAY_FAN_PAD_OPS * n_inst
    return ops


def per_ray_bound(args, got):
    """(least ms, operations, bytes) of one block: per_ray_work's operations
    over the f32 pipes' unfused rate against the bytes the kernels move
    over HBM's bandwidth, each once: the rays (origin, direction, offset);
    the walked boxes' inv_rot and inv_trans rows, the valid hit slots'
    origins rows and the walked triangles' v0, e1, e2 rows; with a cull,
    every culled sphere's centre and radius and the cull buffer's counts
    and kept ids; and the outputs as the kernels write them: a hit slot's
    tk0, tk1, sel_a, sel_b, int64 id and bool (25 B), two events' times and
    sums (32 B), and a ray's six f32 scalars, color_last, int64 triangle,
    int32 n_steps and two bools (50 B)."""
    from nerftex_torch.kernels.per_ray import budgets

    ds, o, _, _, K, _, _, _, _, _ = args
    rb = o.shape[0]
    C, TC = budgets(ds, K, args[7], args[8])
    ops = per_ray_work(args, got)
    boxes, tris = per_ray_walked(args, got)
    n_box = ds.n_instances if boxes is None else int(boxes.numel())
    n_tri = 0 if not ds.n_tris else ds.n_tris if tris is None else int(tris.numel())
    nbytes = rb * 28 + n_box * 48 + int(got["kvalid"].sum()) * 12 + n_tri * 36
    if got["cull"] is not None:
        kept = sum(int(x.numel()) for x in (boxes, tris) if x is not None)
        nbytes += 16 * ((ds.n_instances if C else 0) + (ds.n_tris if TC else 0))
        nbytes += 4 * (4 + kept)
    nbytes += rb * (K * 25 + 2 * K * 16 + 50)
    return max(ops / H100_F32_OPS, nbytes / H100_BYTES_PER_S) * 1e3, ops, nbytes


def main_per_ray(card):
    """Phase 19 (module docstring): the per-ray kernels against the plain
    chain on every ray block of the carpet, grass and plush frames, with
    the operating point's culls and with none; each block's keep sets
    checked; one culled and one full block of each timed (kernel calls
    replayed from a CUDA graph, the plain chain and DeviceInstancer.
    _per_ray by events, _per_ray's host issue time) beside the bound; the
    tracer's per_ray.rays and per_ray.kernel over a frame of _per_ray
    calls.  Returns {scene: row}."""
    from nerftex_torch.kernels import per_ray as pr
    from nerftex_torch.utils import trace

    t_phase = time.perf_counter()
    rows = {}
    for name in PER_RAY_SCENES:
        dev, rays_o, rays_d, params, S, step = per_ray_setup(name)
        rb = dev.ray_block
        n_blocks = rays_o.shape[0] // rb
        knife, worst, fits = [], 0.0, {"instances": 0, "triangles": 0}
        budgets = (dev.cull_budget, dev.tri_cull_budget)
        timed = {}
        for b in range(n_blocks):
            sl = slice(b * rb, (b + 1) * rb)
            for culled in (True, False):
                args = per_ray_args(dev, rays_o[sl], rays_d[sl], S, step, culled)
                before = pr.per_ray.launches
                got = pr.per_ray(*args)
                if pr.per_ray.launches != before + 1:
                    raise AssertionError(f"per_ray {name}: the kernels did not launch")
                want = pr.per_ray_plain(*args)
                edges, err = compare_per_ray(args, got, want)
                knife += [b * rb + r for r in edges]
                worst = max(worst, err)
                sets = per_ray_keep_sets(args, got) if culled else {}
                branch = ("culled" if culled and sets and all(
                    v[2] is not None for v in sets.values()) else "full")
                for kind, v in sets.items():
                    fits[kind] += v[2] is not None
                if branch not in timed and (branch == "full" or b >= n_blocks // 2):
                    timed[branch] = (b, args, got)
        row = {"blocks": n_blocks, "rays_per_block": rb, "K": args[4],
               "knife_edge_rays": knife, "max_float_err": worst, "fits": fits}
        for branch, (b, args, got) in sorted(timed.items()):
            bound, ops, nbytes = per_ray_bound(args, got)
            sl = slice(b * rb, (b + 1) * rb)
            dev.cull_budget, dev.tri_cull_budget = args[7], args[8]
            t0 = time.perf_counter()
            for _ in range(PER_RAY_TIMED_CALLS):
                dev._per_ray(rays_o[sl], rays_d[sl], params[sl], S, step, args[3])
            issue_ms = (time.perf_counter() - t0) * 1e3 / PER_RAY_TIMED_CALLS
            r = {"block": b, "device_ms": device_ms(lambda: pr.per_ray(*args),
                                                     PER_RAY_TIMED_CALLS),
                 "per_ray_ms": time_ms(lambda: dev._per_ray(rays_o[sl], rays_d[sl], params[sl],
                                                            S, step, args[3]), iters=5),
                 "per_ray_issue_ms": issue_ms,
                 "plain_ms": time_ms(lambda: pr.per_ray_plain(*args), iters=3, warmup=1),
                 "bound_ms": bound, "ops": ops, "bytes": nbytes}
            r["share_of_bound"] = r["bound_ms"] / r["device_ms"]
            if not r["share_of_bound"] <= 1.0:
                raise AssertionError(f"per_ray {name} {branch}: {r['device_ms']} ms beats its "
                                     f"bound of {bound} ms")
            row[branch] = r
        dev.cull_budget, dev.tri_cull_budget = budgets
        trace.reset()
        with trace.recording():
            for b in range(n_blocks):
                sl = slice(b * rb, (b + 1) * rb)
                dev._per_ray(rays_o[sl], rays_d[sl], params[sl], S, step,
                             torch.full((rb,), 0.5, device="cuda"))
        totals = trace.totals()
        trace.reset()
        row["counts"] = {k: totals.get(k, 0) for k in ("per_ray.rays", "per_ray.kernel",
                                                        "cull.fit", "cull.full", "sync")}
        if row["counts"]["per_ray.kernel"] != row["counts"]["per_ray.rays"] or row["counts"][
                "per_ray.rays"] != n_blocks * rb:
            raise AssertionError(f"per_ray {name}: counts {row['counts']}")
        log(f"per_ray {name}: {json.dumps(row)}")
        rows[name] = row
        del dev
        torch.cuda.empty_cache()
    log(f"phase per-ray: {time.perf_counter() - t_phase:.1f} s on {card}")
    return rows


def kernel_counts():
    """(reset, read, check) over the kernel wrappers' launch counters:
    reset() zeroes every count; read() gives ({kernel: launches},
    {kernel: {variant: launches}}); check(frame, launches, variants, idle,
    want, shadows) fails unless every kernel outside ``idle`` launched, those
    in it did not, and every launch of a kernel in ``want`` ran its variant;
    shadow_query is idle unless ``shadows`` (the frame casts shadow rays)."""
    from nerftex_torch.kernels import mlp_fused as fused, selk_resolve as selk, tex_gather
    from nerftex_torch.kernels import per_ray as pr, shadow_query as sq

    counters = {"tex_fetch": tex_gather.sample_channel, "mlp_fused": fused.mlp_fused,
                "selk_resolve": selk.selk_resolve, "shadow_query": sq.shadow_query,
                "per_ray": pr.per_ray}

    def reset_counts():
        for fn in counters.values():
            fn.launches = 0
            if hasattr(fn, "variant_launches"):
                fn.variant_launches = dict.fromkeys(fn.variant_launches, 0)

    def read_counts():
        return ({name: fn.launches for name, fn in counters.items()},
                {name: dict(fn.variant_launches) for name, fn in counters.items()
                 if hasattr(fn, "variant_launches")})

    def check_counts(frame, launches, variants, idle=(), want=FRAME_VARIANTS, shadows=False):
        idle = tuple(idle) + (() if shadows else ("shadow_query",))
        for name, n in launches.items():
            if name in idle and n:
                raise AssertionError(f"the {frame} frame launched {name} {n} times, not 0")
            if name not in idle and n <= 0:
                raise AssertionError(f"the {frame} frame did not launch {name}")
        for name, variant in want.items():
            if name not in idle and variants[name][variant] != launches[name]:
                raise AssertionError(f"the {frame} frame ran {name} variants {variants[name]}, "
                                     f"not {variant} alone")

    return reset_counts, read_counts, check_counts


def main():
    import tempfile

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this test needs a CUDA card",
              file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    from nerftex_torch.instancing.scene import load_texture_channels
    from nerftex_torch.kernels import build, mlp_fused as fused, selk_resolve as selk, tex_gather
    from nerftex_torch.ops.rays import frame_rays
    from nerftex_torch.utils import jax_rng, trace
    from nerftex_torch.render.checkpoint import load_jax_params
    from nerftex_torch.utils.util import instantiate

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    # -- build ---------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items()) or 'cached'})")

    # -- kernels vs plain --------------------------------------------------------
    t_phase = time.perf_counter()
    params = npz_params("torch_bench_inputs.npz")
    rows = {}
    for frame, texture in (("bench", "smooth_checkerboard.png"), ("plush", "checkerboard.png")):
        channel = load_texture_channels(os.path.join(ROOT, "meshes", texture))[0]
        rows[frame] = {"tex_fetch": check_tex(tex_gather, channel, texture)}
    mlp = {}
    for name in ("bfloat16", "float32"):
        probe = instantiate(model_config("float32", compute_dtype=name), device="cuda")
        load_jax_params(probe, params)
        mlp[name] = check_mlp(fused, probe, name, MLP_SAMPLES["bench"])
    rows["bench"]["mlp_fused"] = mlp["bfloat16"]
    # The f32 variant (wgmma_tf32x3) has its own row, the f32 bench frame's;
    # the plush and grass topologies' weights ride along in it.
    rows["bench_f32"] = {"mlp_fused": dict(mlp["float32"], topologies={})}
    for scene, model_cfg in (("plush", plush_model_config()), ("grass", grass_model_config())):
        for name in ("bfloat16", "float32"):
            if (scene, name) == ("grass", "bfloat16"):
                continue  # held on the grass frame's own first net_chunk below
            probe = instantiate(dict(model_cfg, compute_dtype=name), device="cuda")
            load_jax_params(probe, npz_params(f"torch_{scene}_inputs.npz"))
            row = check_mlp(fused, probe, name, MLP_SAMPLES[scene])
            if name == "bfloat16":
                rows[scene]["mlp_fused"] = row
            else:
                rows["bench_f32"]["mlp_fused"]["topologies"][scene] = row
    del probe
    for frame in ("bench", "plush"):
        rows[frame]["selk_resolve"] = check_selk(selk, frame)
    log(f"phase kernels: {time.perf_counter() - t_phase:.1f} s")
    counts = kernel_counts()
    reset_counts, read_counts, check_counts = counts

    # -- the bench frame -------------------------------------------------------
    t_phase = time.perf_counter()
    data = frame_rays(512, 512, np.array([0.47, -0.65, 0.6]) * 6.0, 0.55,
                      [1, 1, 1, 0.1, 0, 0, 1.0])

    def build_renderer(precision, compute_dtype="bfloat16"):
        model = instantiate(model_config(precision, compute_dtype), device="cuda")
        load_jax_params(model, params)
        return instantiate(dict(renderer_config(precision), model=model, device="cuda"))

    # The golden frame was rendered on a TPU, where the slab test's and the
    # Fourier lift's f32 matmuls run at DEFAULT precision (bf16 operands);
    # the port reproduces that with matmul_precision="bfloat16".
    renderer = build_renderer("bfloat16")
    reset_counts()
    t0 = time.perf_counter()
    with selk_capture() as selk_calls:
        out = renderer(**data, key=jax_rng.key(1))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    bench_launches, bench_variants = read_counts()
    log(f"bench frame (first render {first_s:.2f} s): launches {bench_launches}, variants "
        f"{bench_variants}")
    check_counts("bench", bench_launches, bench_variants)
    rows["bench"]["selk_resolve"].update(
        selk_frame_record(selk_calls, bench_launches["selk_resolve"], "bench"))
    psnr = golden_psnr(out)
    log(f"golden check: {psnr:.2f} dB (floor {GOLDEN_PSNR_DB})")
    if not psnr >= GOLDEN_PSNR_DB:
        raise AssertionError(f"bench frame diverged from golden: {psnr:.2f} dB")

    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = renderer(**data, key=jax_rng.key(1))
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)
    rays_per_s = 512 * 512 / best
    log(f"bench frame: best of 3 warm renders {best * 1e3:.1f} ms -> {rays_per_s:.1f} rays/s "
        f"on {card}")
    log(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    # Informational: the same frame with every matmul operand in f32.
    f32_out = build_renderer("float32")(**data, key=jax_rng.key(1))
    log(f"golden check with float32 matmul operands: {golden_psnr(f32_out):.2f} dB (not gated)")
    del renderer, out, f32_out
    bench = {"rays_per_s": rays_per_s, "best_ms": best * 1e3, "golden_psnr_db": psnr}
    log(f"phase bench frame: {time.perf_counter() - t_phase:.1f} s")

    # -- the f32 bench frame --------------------------------------------------------
    t_phase = time.perf_counter()
    renderer = build_renderer("bfloat16", compute_dtype="float32")
    reset_counts()
    t0 = time.perf_counter()
    with mlp_capture(every=True) as mlp_calls:
        out = renderer(**data, key=jax_rng.key(1))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    f32_launches, f32_variants = read_counts()
    log(f"f32 bench frame (first render {first_s:.2f} s): launches {f32_launches}, variants "
        f"{f32_variants}; mlp_fused launches {f32_launches['mlp_fused']}, all "
        f"{F32_FRAME_VARIANTS['mlp_fused']}")
    check_counts("f32 bench", f32_launches, f32_variants, want=F32_FRAME_VARIANTS)
    if len(mlp_calls) != f32_launches["mlp_fused"]:
        raise AssertionError(f"f32 bench frame: {len(mlp_calls)} mlp_fused calls captured, "
                             f"{f32_launches['mlp_fused']} launched")
    f32_psnr = golden_psnr(out)
    with mlp_wrap(lambda real, *args: real.mlp_fused_plain(*args)):
        plain = renderer(**data, key=jax_rng.key(1))
    f32_diff = max(float((out[k] - plain[k]).abs().max()) for k in ("color_pred", "alpha_pred"))
    log(f"f32 bench frame: max |kernel - plain MLP| over color and alpha {f32_diff:.3g} (limit "
        f"{F32_FRAME_MAX_DIFF}); golden {f32_psnr:.2f} dB (information only: the golden holds a "
        f"bf16 MLP)")
    if not f32_diff <= F32_FRAME_MAX_DIFF:
        raise AssertionError(f"the f32 bench frame through the kernel differs from the plain "
                             f"MLP's by {f32_diff}")
    del plain
    f32_best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        renderer(**data, key=jax_rng.key(1))
        torch.cuda.synchronize()
        f32_best = min(f32_best, time.perf_counter() - t0)
    # The frame's MLP: its launches, as captured, replayed from one graph,
    # beside the cuBLAS f32 chain on the same inputs (padding included on
    # both sides) and the summed bound.
    packed = mlp_calls[0][2]
    chain = cublas_chain(packed, torch.float32)
    f32_frame = {
        "rays_per_s": 512 * 512 / f32_best, "best_ms": f32_best * 1e3, "golden_psnr_db": f32_psnr,
        "plain_max_abs_diff": f32_diff, "mlp_launches": len(mlp_calls),
        "mlp_samples": sum(c[0].shape[0] for c in mlp_calls),
        "mlp_device_ms": device_ms(lambda: [fused.mlp_fused(*c) for c in mlp_calls], iters=1),
        "cublas_device_ms": device_ms(lambda: [chain(*cublas_inputs(
            c[2], c[0], c[1], torch.float32)) for c in mlp_calls], iters=1),
        "mlp_bound_ms": sum(mlp_bounds(c[2], c[0].shape[0], "float32")[0] for c in mlp_calls),
    }
    log(f"f32 bench frame: best of 3 warm renders {f32_best * 1e3:.1f} ms -> "
        f"{f32_frame['rays_per_s']:.1f} rays/s; MLP over the frame's {len(mlp_calls)} launches "
        f"({f32_frame['mlp_samples']} samples): kernel device {f32_frame['mlp_device_ms']:.3f} ms, "
        f"cuBLAS f32 chain {f32_frame['cublas_device_ms']:.3f} ms, bound "
        f"{f32_frame['mlp_bound_ms']:.3f} ms on {card}")
    rows["bench_f32"]["mlp_fused"].update(
        frame_device_ms=f32_frame["mlp_device_ms"], frame_cublas_device_ms=f32_frame[
            "cublas_device_ms"], frame_bound_ms=f32_frame["mlp_bound_ms"],
        frame_samples=f32_frame["mlp_samples"])
    mlp_calls.clear()  # the capture's closure may outlive the list's name
    del renderer, out, mlp_calls, chain
    torch.cuda.empty_cache()
    log(f"phase f32 bench frame: {time.perf_counter() - t_phase:.1f} s")

    # -- the plush frame ----------------------------------------------------------
    t_phase = time.perf_counter()
    p_data, p_params, h, w = scene_data("plush")
    model = instantiate(plush_model_config(), device="cuda")
    load_jax_params(model, p_params)
    renderer = instantiate(dict(plush_renderer_config(), model=model, device="cuda"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trace.reset()
    with selk_capture() as selk_calls, trace.recording():
        out = renderer(**p_data, key=jax_rng.key(1))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    plush_launches, plush_variants = read_counts()
    log(f"plush frame (first render {first_s:.2f} s, recorded by the tracer): launches "
        f"{plush_launches}, variants {plush_variants}, shadow branches {shadow_branches()}")
    check_counts("plush", plush_launches, plush_variants, shadows=True)
    rows["plush"]["selk_resolve"].update(
        selk_frame_record(selk_calls, plush_launches["selk_resolve"], "plush"))
    p_psnr = frame_psnr("plush", out, h, w)
    log(f"plush golden check: {p_psnr:.2f} dB (floor {PLUSH_GOLDEN_PSNR_DB}, 10x downsample)")
    if not p_psnr >= PLUSH_GOLDEN_PSNR_DB:
        raise AssertionError(f"plush frame diverged from golden: {p_psnr:.2f} dB")
    p_best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        renderer(**p_data, key=jax_rng.key(1))
        torch.cuda.synchronize()
        p_best = min(p_best, time.perf_counter() - t0)
    p_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"plush frame: best of 2 warm renders {p_best * 1e3:.1f} ms -> "
        f"{h * w / p_best:.1f} rays/s, peak device memory {p_peak:.2f} GiB on {card}")
    log(f"phase plush frame: {time.perf_counter() - t_phase:.1f} s")
    plush = {"rays_per_s": h * w / p_best, "best_ms": p_best * 1e3, "golden_psnr_db": p_psnr,
             "peak_gib": p_peak}
    del renderer, model, out

    # -- the grass frame ----------------------------------------------------------
    t_phase = time.perf_counter()
    g_data, g_params, h, w = scene_data("grass")
    model = instantiate(grass_model_config(), device="cuda")
    load_jax_params(model, g_params)
    renderer = instantiate(dict(grass_renderer_config(), model=model, device="cuda"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    trace.reset()
    with selk_capture(keep_inputs=True) as selk_calls, mlp_capture() as mlp_calls, \
            trace.recording():
        out = renderer(**g_data, key=jax_rng.key(1))
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    grass_launches, grass_variants = read_counts()
    log(f"grass frame (first render {first_s:.2f} s, recorded by the tracer): launches "
        f"{grass_launches}, variants {grass_variants}, shadow branches {shadow_branches()}")
    # Grass has no texture channel (textures ["", "point"]): no tex_fetch.
    check_counts("grass", grass_launches, grass_variants, idle=("tex_fetch",),
                 shadows=True)
    g_psnr = frame_psnr("grass", out, h, w)
    log(f"grass golden check: {g_psnr:.2f} dB (floor {GRASS_GOLDEN_PSNR_DB}, 8x downsample)")
    if not g_psnr >= GRASS_GOLDEN_PSNR_DB:
        raise AssertionError(f"grass frame diverged from golden: {g_psnr:.2f} dB")
    g_best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        renderer(**g_data, key=jax_rng.key(1))
        torch.cuda.synchronize()
        g_best = min(g_best, time.perf_counter() - t0)
    g_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"grass frame: best of 2 warm renders {g_best * 1e3:.1f} ms -> "
        f"{h * w / g_best:.1f} rays/s, peak device memory {g_peak:.2f} GiB on {card}")
    # The kernels at the grass frame's own inputs: the MLP on its first
    # net_chunk of samples, the overlap pick on every launch of the frame.
    rows["grass"] = {
        "mlp_fused": mlp_kernel_row(fused, mlp_calls[0][2], [mlp_row(
            fused, mlp_calls[0][2], *mlp_calls[0][:2], "bfloat16",
            "the grass frame's first net_chunk")]),
        "selk_resolve": dict(check_selk_frame(selk, selk_calls, "grass"),
                             **selk_frame_record(selk_calls, grass_launches["selk_resolve"],
                                                 "grass")),
    }
    del selk_calls, mlp_calls
    grass = {"rays_per_s": h * w / g_best, "best_ms": g_best * 1e3, "golden_psnr_db": g_psnr,
             "peak_gib": g_peak, "first_render_s": first_s}
    del renderer, model, out
    torch.cuda.empty_cache()
    log(f"phase grass frame: {time.perf_counter() - t_phase:.1f} s")

    # -- the carpet and carpet10k frames ------------------------------------------------
    frames = {"bench": bench, "bench_f32": f32_frame, "plush": plush, "grass": grass}
    launches = {"bench": bench_launches, "bench_f32": f32_launches, "plush": plush_launches,
                "grass": grass_launches}
    for scene in ("carpet", "carpet10k"):
        t_phase = time.perf_counter()
        frames[scene], rows[scene], launches[scene] = carpet_frame(scene, params, counts, card)
        log(f"phase {scene} frame: {time.perf_counter() - t_phase:.1f} s")

    # -- serving: RenderSession at the grass operating point -----------------------
    t_phase = time.perf_counter()
    serve, serve_launches = serve_grass(g_params, h, w, reset_counts, read_counts, check_counts,
                                        card, g_psnr)
    rows["grass"]["mlp_fused"]["serve_launches"] = serve_launches["mlp_fused"]
    rows["grass"]["selk_resolve"]["serve_launches"] = serve_launches["selk_resolve"]
    log(f"phase serving: {time.perf_counter() - t_phase:.1f} s")

    # -- the render mode: nerftex_torch.main on grass_filtered ----------------------------
    t_phase = time.perf_counter()
    frames["grass_filtered"], rows["grass_filtered"], launches["grass_filtered"] = (
        main_render_mode(npz_params("torch_grass_filtered_inputs.npz"), counts, card))
    log(f"phase render mode (nerftex_torch.main): {time.perf_counter() - t_phase:.1f} s")

    # -- training: the full-width step against JAX, then nerftex_torch.main -----
    t_phase = time.perf_counter()
    train, train_rows, train_launches = main_training(counts, card)
    frames.update(train)
    rows.update(train_rows)
    launches.update(train_launches)
    log(f"phase training: {time.perf_counter() - t_phase:.1f} s")

    # -- device-resident training: full_carpet_train_device through main --------
    t_phase = time.perf_counter()
    keep = tempfile.TemporaryDirectory(dir=ROOT, prefix="_parallel_data_")
    parallel_tfr = os.path.join(keep.name, f"records{DEVICE_TRAIN_CHECK_VIEWS}.tfr")
    train, train_rows, device_launches = main_device_training(counts, card, parallel_tfr)
    frames.update(train)
    rows.update(train_rows)
    launches.update(device_launches)
    log(f"phase device-resident training: {time.perf_counter() - t_phase:.1f} s")

    # -- the mip paths: demo_grass_mip_train then demo_grass_mip_render ------------
    t_phase = time.perf_counter()
    mip, mip_rows, mip_launches = main_mip(counts, card)
    frames.update(mip)
    rows.update(mip_rows)
    launches.update(mip_launches)
    log(f"phase mip: {time.perf_counter() - t_phase:.1f} s")

    # -- the compact path: bench at a covering and a dropping budget, f32 vs JAX, mip --
    t_phase = time.perf_counter()
    compact, phase_rows, compact_launches = main_compact(params, counts, card)
    frames.update(compact)
    rows.update(phase_rows)
    launches.update(compact_launches)
    log(f"phase compact: {time.perf_counter() - t_phase:.1f} s")

    # -- parallelism: gloo ranks on the card, then an NCCL world of one -------------
    t_phase = time.perf_counter()
    frames["parallel"], rows["carpet_sharded"], launches["carpet_sharded"] = main_parallel(
        card, parallel_tfr)
    keep.cleanup()
    log(f"phase parallel: {time.perf_counter() - t_phase:.1f} s")

    # -- tensor parallelism and the offline tools ----------------------------------
    t_phase = time.perf_counter()
    frames["tensor_parallel"], rows["carpet_tp"], launches["carpet_tp"] = main_tensor_parallel(
        card)
    log(f"phase tensor parallel and tools: {time.perf_counter() - t_phase:.1f} s")

    # -- the device instancer against the host oracle ---------------------------
    frames["oracle"] = main_oracle(counts, card)

    # -- the shadow query kernel against its plain chain, timed ------------------
    for scene, row in main_shadow_query(card).items():
        rows[scene]["shadow_query"] = row

    # -- the per-ray kernels against the plain chain, timed ----------------------
    for scene, row in main_per_ray(card).items():
        rows[scene]["per_ray"] = row

    kernels = [dict(row, frame=frame, launches=launches[frame][name])
               for frame in launches for name, row in rows[frame].items()]
    log(json.dumps({"frames": frames, "serving": serve, "card": card,
                    "seconds": time.perf_counter() - t_start}))
    log(card)
    why = "configs/config_grass_render.py has no texture channel (textures ['', 'point'])"
    log(json.dumps({"kernels": kernels, "not_launched": [
        {"frame": "grass", "name": "tex_fetch", "launches": grass_launches["tex_fetch"],
         "why": why},
        {"frame": "grass serving", "name": "tex_fetch", "launches": serve_launches["tex_fetch"],
         "why": why},
        {"frame": "grass_filtered", "name": "tex_fetch",
         "launches": launches["grass_filtered"]["tex_fetch"],
         "why": "configs/config_grass_filtered_render.py has no texture channel (textures "
                "['', '', 'light'])"},
        {"frame": "grass_mip", "name": "tex_fetch", "launches": launches["grass_mip"]["tex_fetch"],
         "why": "configs/demo_grass_mip_render.py has no texture channel (textures "
                "['', '', 'light'])"},
        {"frame": "grass_mip_compact", "name": "tex_fetch",
         "launches": launches["grass_mip_compact"]["tex_fetch"],
         "why": "configs/demo_grass_mip_render.py has no texture channel (textures "
                "['', '', 'light'])"}] + [
        {"frame": frame, "name": name, "launches": launches[frame][name],
         "why": "training has no instancer: its validation renders run the plain Renderer "
                "(MipRenderer for the mip configs)"}
        for frame in ("carpet_train", "grass_filtered_train", "carpet_train_device",
                      "grass_mip_train", "carpet_tp")
        for name in ("tex_fetch", "selk_resolve", "per_ray")] + [
        {"frame": frame, "name": "shadow_query", "launches": n["shadow_query"],
         "why": "the frame casts no shadow rays (cast_shadow_rays false, or no instancer)"}
        for frame, n in launches.items() if n.get("shadow_query") == 0]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        parallel_worker(*sys.argv[2:])
    else:
        main()
