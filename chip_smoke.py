#!/usr/bin/env python3
"""Smoke run of the PyTorch port (vit2spn_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its result on its own line; any failure raises and the
script exits non-zero without printing a result:

  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel from csrc/ (one nvcc per source, all started
     together), with seconds and the compiler's registers, spill stores and
     static shared memory per kernel (of the attention kernels templated on
     S, the instantiation for S = 197; their shared memory is dynamic), and
     the dynamic shared memory of the forward layer's three kernels at
     S = 197;
  3. the backbone-forward kernel against its plain PyTorch twin on the card,
     at the shapes the serving path gives it (ViT-Tiny: L=12, D=192, 3 heads,
     mlp 768, S=197, B=256, bf16), both gelu forms and both emit_res
     settings, and at a few other shapes it takes (ragged batches, short and
     256-token sequences, D = 256, the widest layer kept in one block, and
     the ViT-Small and ViT-Base widths, which take the seven-launch wide
     route);
  4. the two backward kernels (one layer's MLP half and attention half)
     against their plain twins at the training shape (ViT-Tiny, B=128), both
     gelu forms, dx and every weight gradient, and as close to an fp32
     backward as the twins are; at S = 5, 17 and 256, a ragged B at S = 197,
     D = 256 and 128 (mlp 320), and the ViT-Small width; two runs of each
     half giving the same bits; the forward kernel at the training shape
     (B=128, emit_res) against its twin, as in phase 3; the 12-layer
     backward through the autograd Function against
     `backbone_backward_plain` on that forward's residuals; two backward
     runs giving the same weight-gradient bits;
  5. the fp32-inside attention kernels (flash forward and backward) against
     their plain twins: o, dq, dk, dv at the training shape (B=128) and the
     serving shape (B=256), at S = 5, 17 and 256, a ragged B, and with fp32
     inputs; at each shape as close to the function computed in float64 as
     the twin is (a kernel that rounded P or dS to bf16 would not be); two
     backward runs at B=128 giving the same dq, dk, dv bits;
  6. the one-layer forward kernel against its twin at B=128 and 256, both
     gelu forms (out and x2), and 12 `fused_block` calls against one
     `fused_backbone`: every output bit equal;
  7. the merged layer backward against the split kernels and its twin, dx
     and all 12 weight gradients: at B=128 (both gelu forms), a ragged B at
     S = 197, D = 128 with mlp 320 and D = 256 every bit must equal the split
     pair's (the same wgmma stages and orders of sums); at the ViT-Small
     width (the mma.sync sequences) the share of equal bits is reported; two
     runs giving the same weight-gradient bits; one call's launches (its
     counter, and 10 CUDA launches: the split pair's 11 less one reduction);
  7b. the fp32 routes of the five fused kernels (compute_dtype=float32)
     against their fp32 twins and against the same twins run in float64: one
     layer of each at B=128 and at the ViT-Small width, the 12-layer forward
     at B=256 (both emit_res settings), the 12-layer backward through the
     Function at B=32; and a launch the C side refuses raises;
  8. the serving path end to end: SSPTrainer on the dual-stream `ssp` preset
     (random init from the seed) runs extract_features over 1024 synthetic
     28 px images at batch 256, through attn_impl "fused", then "pallas" and
     "fused_layer". The launch counters are set to 0 just before each run
     and read just after: only that path's forward kernel ran; the features
     must be finite, (1024, 128), and agree with the same path run through
     the plain twin; then under compute_dtype=float32 through "fused" (the
     fp32 backbone kernel only) against the fp32 plain path;
  9. the training path end to end: `fit` of the `ssp` preset (full width and
     depth, 8 microbatches of 128, bf16) over 4096 synthetic 28 px images,
     four optimizer steps, with the counters set to 0 just before and read
     just after: finite losses, 32 forward launches and 192 launches of each
     backward kernel per step; and step 1 against the same step run with
     attn_impl="plain" from the same state (loss, Adam's first moments, the
     updated params); under compute_dtype=float32, step 1 of "fused" against
     "plain" and one step each of "fused", "fused_layer" and merged "fused"
     with the counters read around it (the fp32 kernels' launches); an
     SSPTrainer with VIT2SPN_VIT_TINY_PATH at an HF-named .npz written from
     seeded random weights records "pretrained" and holds the file's weights
     on the card;
 10. the other backbone paths end to end, at the same width and depth: for
     "pallas", "fused_layer" and "fused" with VIT2SPN_MERGED_BWD=1, step 1
     against a reference path from the same state ("xla", "fused", the
     split backward), then `fit` of two optimizer steps over 2048 images
     with the counters read around it (per step: 384 flash forwards and 192
     flash backwards; 384 layer forwards and 192 of each split half; 32
     backbone forwards and 192 merged backwards, no split half, and the
     merged step's CUDA launches of the backward against the split step's),
     and the step's images/s and device time by wrapper;
 10b. the fine-tune path end to end, at the `ft-octmnist` preset's width and
     depth (B=128, bf16, 4 classes): step 1 of FineTuneTrainer through
     "fused" against "plain" (bf16 and fp32; head dropout on, the same
     streams; loss, Adam's first moments, updated params, BN running
     statistics; in bf16 also each path's distance from the fp32 step and
     the two paths' distance on the blocks) and the split backward against
     VIT2SPN_MERGED_BWD=1 (every bit equal); `evaluate` of 512 images
     through "fused" against "plain" from one state (the backbone forward's
     no-residual route only); a warm step's wall time (beside the same
     steps timed right after the build, and here with the garbage
     collector's objects frozen) and its device time by wrapper (card
     idle); then
     `run ft-octmnist` through the CLI from an export of phase 9's SSP
     trainer, cut to 3 folds and 2 epochs, with the counters set to 0 just
     before and read just after: per train step 1 backbone forward and 12
     of each backward half, per eval batch 1 backbone forward, nothing
     else; its four artifacts, finite fold mAUCs, and per-fold device
     memory that rises by at most one kept model;
 12. the folder datasets and the parity runbook end to end, at the same
     width and depth (bf16), on inputs staged in a temporary directory: an
     octmnist.npz (28 px, 16,384 / 2,048 / 2,048 images, the multitrial
     subset's classes balanced), 572 non-square OCTID files over 5 classes,
     a UCSD train/test tree merged by `data merge-ucsd` into 2,048 files,
     and the seeded HF-layout weight file through VIT2SPN_VIT_TINY_PATH:
     (a) `data stats octid` and the folder decodes' host seconds; (b) the
     folder presets' augmentation at 256 px sources (square with UCSD's
     0.5/0.5 normalization, and a non-square decode) on the card against the
     same function on the CPU from the same parameters; a warm B=128
     ft-ucsdoct step's wall and device time by wrapper (card idle); (c)
     `run ft-ucsdoct` through the CLI, cut to 3 folds and 1 epoch; (d)
     `run_parity(epochs=1, ft_epochs=1)` on the staged root, multitrial
     included: its status equals `compute_status` of the written report,
     init_provenance "pretrained", every stage's entry present; for (c) and
     (d) the launches of backbone_fwd, mlp_bwd and attn_bwd predicted from
     the protocols' sizes, exactly, and no other wrapper; (e) `convert` of
     (d)'s export to .pth and back with equal leaves, `inspect`, and `plot
     roc` / `cm` of (c)'s cv_result.json (its former (e), a `run ssp
     --profile` of its own, went for the script's time: phase 13 (a)'s plain
     run carries --profile and takes its checks);
 13. several ranks (parallel/), at the end: (a) `run ssp` cut to one epoch of
     800 staged images at 2 x 128 with a checkpoint and --profile, plain
     and under torchrun (world size 1, NCCL), side by side: export and checkpoint equal bit
     for bit, the wrappers' calls as predicted in both; the plain run's
     profile_op lines name the three wrappers' ranges, device_memory reads
     nonzero, model_info's backbone GFLOPs equal the products counted here
     (check_profile_run); (b) 2 gloo ranks
     sharing cuda:0 against world size 1 from one state, fp32 and bf16: the
     SSP step with an uneven masked tail and a one-step fine-tune epoch with
     global BN (compare_steps), evaluate, each rank's launches equal world
     size 1's, and a 2 x 128 bf16 step's wall, device and all-reduce time by
     rank; (c) the dry run's three stages (`entry.py::_dryrun_rank`, what
     `dryrun_multichip(2)` runs) on (b)'s two ranks (three OK lines, 27
     sharded leaves) (its former (d), `parity --smoke`, runs in phase 17:
     the kernels now take its head_dim 16; its world-1 NCCL step process
     went for the script's time, (a)'s torchrun run holding NCCL at world
     size 1);
 11. times with CUDA events after a warm-up: each kernel, its plain twin, a
     library yardstick (F.layer_norm / torch.matmul / SDPA / F.gelu, and
     their torch autograd for the backward kernels; for the flash kernels
     also SDPA on fp32 copies, which keeps P and dS in fp32, with its error
     against float64) and the least time the card could take for the same
     work, for the bf16 kernels and the fp32 routes; the backbone forward's
     device time by CUDA kernel (stage) beside the library yardstick's, at
     B=256; the attention stage's device time (the forward's
     attention_kernel) per B=256 backbone forward and per B=128 launch,
     beside SDPA's device time on the same attentions and the stage's bytes
     bound; the backward kernels' by stage at B=128 (the bf16 halves and
     merged, the fp32 halves); the fp32 GEMM of every fp32 route alone
     against torch.matmul in fp32 at the backward's shapes, in ms and
     TFLOP/s; extract images/s;
     the "fused"
     optimizer step's images/s, and from torch.profiler its device time by
     kernel wrapper (each wrapper's `vit2spn::<name>` range) and by CUDA
     kernel.

 14. the model zoo, after phase 11 and before phase 13: ViT-Small/16 (D 384, 6 heads, mlp 1536) and
     ViT-Base/16 (D 768, 12 heads, mlp 3072), the JAX package's other
     geometries (`-o vit=small|base`), at full width and depth: (a) the bf16
     backward halves' wide route (mlp_bwd, attn_bwd, merged_bwd) against
     their twins at B=128 (both gelu forms, and as close to fp32 as the
     twins), a ragged B, S = 17 and 256; merged equal to the split pair bit
     for bit; two runs of each giving equal bits; one call of each with its
     counter, its CUDA launches (7, 7, 13) and no mma.sync GEMM in the
     trace of ten calls; the forward's wide route the same way:
     fused_backbone (12 layers, with and without emit_res) and layer_fwd
     against their twins at every shape, as close to fp32 as the twins at
     B=128, and at D = 512 (8 heads, mlp 2048, tile_gemm's 128-column
     tiles), 12 fused_block calls equal to one fused_backbone bit for bit,
     two runs equal, one call of each with its counter and its CUDA
     launches (84, 7); (b) `ssp-scratch -o vit=<name>` training (8 x 128, bf16, 224 px
     from 28 px sources, 6 of the 12 layers): step 1 of "fused" against "xla" from one state
     (the moments within phase 9's tolerances; fused as close to the fp32
     step as "xla" is), then `fit` of two "fused" steps and one merged step with the counters
     read around each, and each step's wall, img/s, device time by wrapper
     and card idle; (c) extract at batch 256 against the plain path, with
     img/s and the forward's device time; (d) at ViT-Small, `run
     ssp-scratch -o vit=small` for one epoch on a staged npz, then `run
     ssp-ssl/ft-octmnist -o vit=small -o init=scratch` from its export, cut
     to 2 folds and 1 epoch, each with its predicted launches; (e) the
     times of backbone_fwd (B=256), layer_fwd, mlp_bwd, attn_bwd and
     merged_bwd (B=128) at both widths beside their twins, library
     yardsticks and bounds, each backward's device time by stage, and the
     B=256 forward's device time by launch with each GEMM's TFLOP/s.
     `python3 chip_smoke.py --zoo-times` runs the build and (e) alone, for
     timing another tree's kernels with the same code (the parents' routes
     in PERF.md were measured so).
 15. inputs above 256 tokens, after phase 14 and before phase 13: the four
     bf16 attention kernels' multi-pass routes (csrc/long_attention.cuh).
     (a) At S = 257, 577, 785 and 1024, D = 192 (3 heads) and 768 (12),
     ragged B: the forward layer's attention stage and the backward's
     attention core alone (their C entry points) against their twins and
     as close to fp32 as the twins, the core's att equal to the stage's
     bit for bit, two core runs equal; the flash pair as phase 5 holds it,
     two backward runs equal, and the flash backward once more at S =
     65,600 (B = 1, one head; row sums on both sides of 2^16), at head_dim
     64 and at 16 and 80 (general_long.cuh; two heads), against the
     twin's function in blocks of 2,048 queries, two runs equal; a 2-layer
     fused_backbone, both backward
     halves and merged (equal to the split pair bit for bit, two runs of
     each equal) through the wrappers; at S = 577, 12 fused_block calls
     equal to one fused_backbone, one call of each wrapper with its
     counter and its route's count; the routes' branch-free quotient equal to __fdiv_rn bit for bit on 2^27
     random pairs and the edges where the routes take it; whether the
     key-major phase's scores K Q^T equal Q K^T bit for bit (recorded); the
     core at its longest S against its twin, one query tile past it refused
     by the C entry and by the wrappers' check. (b)
     ViT-Base/16-384 (`ssp-scratch -o vit=base -o vit.image_size=384 -o
     data.augment.out_size=384`, bf16, cut to 2 x 64 images a step and to 6
     of its 12 layers): step 1
     of "fused" against "xla" and the fp32 step, `fit` of two "fused"
     steps, one merged and one "pallas" step with every counter as
     predicted, the "fused" and "pallas" steps' device time by wrapper, and
     extract of 512 images against the plain path. (c) `run ft-ucsdoct` at
     256 px (S = 257, 2 folds, 1 epoch, random init) on phase 12's stand-ins
     with its
     predicted launches. (d) Each route by launch at (b)'s and (c)'s
     attentions beside its bound, its twin and bf16 SDPA (or its
     backward), the flash pair also beside SDPA on fp32 copies (the same
     function: P and dS in fp32). `python3 chip_smoke.py --long-seq` runs
     the build and this phase alone.
 16. fp32 above 256 tokens (compute_dtype=float32), after phase 15 and
     before phase 13: the multi-pass route of csrc/flash_f32.cuh behind
     every fp32 attention. (a) At phase 15's S, B and widths: the fp32
     forward stage and attention core alone (their C entry points), the
     flash pair, a 2-layer fused_backbone and the four one-layer kernels
     through the wrappers, each against its fp32 twin and as close to
     float64 as the twin; the core's att equal to the stage's, two runs of
     the core, the flash backward, attn_bwd and merged_bwd equal, merged
     equal to split, all bit for bit; at S = 577, 12 fused_block calls
     equal to one fused_backbone and one call of each wrapper with its
     counter and its route's count. (b) fp32 ViT-Base/16-384 (phase 15
     (b)'s overrides and cut, `-o compute_dtype=float32`): step 1 of
     "fused" against "xla", `fit` of one merged, one split "fused" and one
     "pallas" step with every counter as predicted, the split step's
     device time by wrapper. (c) `run ft-ucsdoct -o compute_dtype=float32`
     at 256 px as phase 15 (c), and the parity runbook keeping "fused" for
     fp32 at S = 257 and 577. (d) Each fp32 route by launch at (b)'s and
     (c)'s attentions beside its bound (67 TFLOP/s), its twin and SDPA in
     fp32 (TF32 off). `python3 chip_smoke.py --fp32-long` runs the build
     and this phase alone.
 17. head_dim 16, 32 and 48 and D below 64 (the kernels' general route),
     after phase 16 and before phase 13: (a) at D 32 / 64 / 96 (2 heads)
     and D 192 at 12 / 6 / 4 heads, S = 5 / 50 / 197 / 256, ragged B, and
     at the main path's B = 128 (S = 5 at D 32, 197 at D 192), bf16
     and fp32: a 2-layer fused_backbone (with and without its stacks),
     layer_fwd, mlp_bwd, attn_bwd, merged_bwd (equal to the split pair bit
     for bit) and the flash pair against their twins (and fp32 or float64),
     each wrapper's counter raised by one a call; (b) each route's CUDA
     launches against the predicted counts, and in a fresh process
     (`chip_smoke.py --hd-trace`) the device kernels of traced calls, equal
     to the route's and to the predicted count; (c) two runs of each backward equal bit for bit; (d) the
     main path: the tiny model (D 32, 2 heads, mlp 64, 2 layers, 32 px)
     and ViT-Tiny's width at 6 and 4 heads through "fused": step 1 against
     "plain" and "xla" and in fp32, `fit` through "fused", merged,
     "fused_layer", "pallas" and fp32 "fused" with every counter as
     predicted; at the tiny model `run ssp-scratch` in bf16 and fp32,
     `extract`, `run ft-octmnist` from the export and `parity --smoke`
     (moved here from phase 13 (d): it now logs "fused"); (e) each
     kernel's time at D 192, B = 128, S = 197 per head_dim beside the
     head_dim-64 route, the twin and the library call. `python3
     chip_smoke.py --head-dim` runs the build and this phase alone, with
     ptxas's registers and spills of every instantiation on head_dim 16,
     32 and 48.
 18. ViT-Large/16 (D 1024, 16 heads, mlp 4096, 24 layers, through the
     dotted overrides `-o vit.hidden_size=1024 -o vit.num_heads=16 -o
     vit.mlp_dim=4096 -o vit.num_layers=24`), after phase 17 and before
     phase 13, in a process of its own (`chip_smoke.py --vit-large`): (a)
     at a ragged B, S = 17 and the training shape (B=128), both gelu
     forms: fused_backbone (24 layers, with and without its
     stacks; also at the serving shape B=256), layer_fwd, mlp_bwd, attn_bwd
     and merged_bwd against their twins and as close to fp32 as the twins;
     merged equal to the split pair bit for bit; at B=128 24 fused_block
     calls equal to one fused_backbone, two runs of each wrapper equal, one
     call of each with its counter and its CUDA launches (168, 7, 7, 7, 13)
     and no mma.sync GEMM in its trace; the flash pair at 16 heads the same
     way; the fp32 routes at B=128 against the fp32 twins and float64; D =
     896 (14 heads, mlp 3584) and S = 577, 2 layers each (at S = 577 in
     fp32 too). (b) `ssp-scratch` with those overrides, bf16, cut to 2
     x 64 images a step and 8 of the 24 layers, on one trainer
     (its random init is drawn once): step 1 of "fused" against "xla" and the fp32 step from one
     state, then `fit` of two "fused" steps, one merged, one "pallas" and
     one fp32 "fused" step with every counter as predicted, the "fused"
     step's device time by wrapper and card idle. (c) extract of 512 images
     at batch 256 from the trained state against the plain path, with img/s
     and the forward's device time. (d) The times of the five layer kernels
     (the forward at B=256, the others at B=128) and the flash pair at 16
     heads beside their twins, library calls and bounds, the backward's
     device time by stage and the forward's by launch. `python3
     chip_smoke.py --vit-large` runs the build and this phase alone.
 19. the general route above 256 tokens (head_dim 16, 32 and 48, and head
     dim 64 with D or mlp not a multiple of 64, at S > 256), after phase 18
     and before phase 13, in a process of its own (`chip_smoke.py
     --general-long`): (b) first, a trace of each wrapper at ViT-Tiny's
     width with 6 heads, S = 290, bf16 and fp32 (the route's kernels only,
     the predicted CUDA launches, the counters, two backward runs equal),
     and the C entries' launch counts at head_dim 64 with mlp 96 and 736;
     (a) at D 32 / 64 / 96 (2 heads) and D 192 at 12 / 6 / 4 heads, S =
     257, 290, 577, 1024 (fp32 also 1,200), ragged B and the main path's B
     = 128 / 64: the stage and the core alone and the flash pair against
     their twins and fp32 (bf16) or float64 (fp32), core att = stage att
     and two runs equal bit for bit; phase 17 (a)'s wrapper checks at S =
     257 and 290 (merged equal to split bit for bit), at head_dim 64 with
     mlp 96 and 736 too; the bf16 core at its longest S at head_dim 16 and
     one query past it refused; (c) ViT-Tiny's width at 6 and 4 heads at
     384 px (2 x 64 images, 6 of 12 layers): step 1 against "plain" and
     "xla", fits through "fused", merged, "fused_layer", "pallas" and fp32
     "fused" (and fp32 "pallas" at 6 heads) with every counter as
     predicted; `run ft-ucsdoct` at 256 px (6 heads bf16, 4 heads fp32);
     the tiny model at 256 px: `run ssp-scratch` and `extract` through the
     CLI, "pallas" fit and extract, extract through "fused" against the
     plain path; the parity runbook keeping "fused"; (d) each new route's
     time at D 192, B = 64, S = 577 and B = 128, S = 257 per head_dim
     beside its twin, SDPA, its bound and the head_dim-64 route's kernel.
     `python3 chip_smoke.py --general-long` runs the build and this phase
     alone.
 20. ViT-Huge/14 (D 1280, 16 heads of 80, mlp 5120, 32 layers, patch 14:
     S = 257; `-o vit.hidden_size=1280 -o vit.num_heads=16 -o
     vit.mlp_dim=5120 -o vit.num_layers=32 -o vit.patch_size=14`), after
     phase 19 and before phase 13, in a process of its own (`chip_smoke.py
     --vit-huge`): (a) the ptxas lines of the head_dim-80 kernels and the
     LayerNorm at 40 values a lane; a trace of each wrapper at D 1280, B =
     2, S = 257 (bf16 and fp32: the route's kernels only, the predicted
     launches, the counters); at a ragged B at S = 17 and the training
     shape B = 64, S = 257, every wrapper against its twin and as close to
     fp32 as the twin (the 32-layer forward also at the serving shape B =
     256), merged equal to split bit for bit, 32 fused_block calls equal to
     one fused_backbone, two runs of each wrapper equal, the CUDA launches
     as predicted, the flash pair at head_dim 80 and the fp32 routes
     against float64; the head_dim-80 attention kernels alone at S = 577
     and 1,024; the core at its longest S at head_dim 80 (11,072) and one
     query past it refused; D 1280 as 20 heads of 64 (the fast route), 2
     layers; head_dim 96 and D = 1312 refused. (b) `ssp-scratch` with those
     overrides, 2 x 64 images a step, one trainer: step 1 against "xla"
     and fp32 "xla", fits through "fused", merged, "fused_layer", "pallas",
     fp32 "fused" and fp32 "pallas" with every counter as predicted and
     each path's peak memory. (c) extract at batch 256 against the plain
     path. (d) the times: the 32-layer forward at B = 256, the layer
     kernels and the flash pair at B = 64, the attention stage and core
     alone at B = 64, S = 257 and 577. `python3 chip_smoke.py --vit-huge`
     runs the build and this phase alone.

The line before the last is one JSON object {"kernels": [...]} with each
kernel's numbers (`launches` on its training path, `finetune_launches` in
the `run ft-octmnist` of phase 10b, `parallel_launches` on rank 0 of phase
13's (b), `folder_launches` in phase 12's (c) and
(d); the bf16 backbone_fwd and layer_fwd entries also carry
`attention_stage_ms`, `attention_stage_bound_ms` and `attention_library_ms`
from phase 11; phase 14 adds an entry per kernel and width, named
"<kernel> (D=384)" and "(D=768)", its `launches` from (b); phase 15 one per
long route, "<route> (S>256)", its `launches` from (b), `ft_256px_launches`
from (c) and its (c)-shape times in `at_256px`; phase 16 the same per fp32
long route, "<route> (fp32, S>256)"; phase 17 one per kernel and head_dim,
"<kernel> (head_dim 16)" and so on, in fp32 too at head_dim 32, its
`launches` from (d) at that head_dim, its times from (e) beside
`head_dim_64_ms`; phase 18 one per kernel at ViT-Large's width, "<kernel>
(D=1024)", its `launches` from (b); phase 19 one per new route and head
dim, "<route> (S>256, hd 16)" and so on (fp32 at head_dim 32), its
`launches` from (c) at that head_dim and dtype, its times at B = 64, S =
577 beside `head_dim_64_ms` and in `at_256px`; phase 20 one per layer kernel
at ViT-Huge/14's width, "<kernel> (D=1280)", and per flash kernel and
dtype, "<kernel> (hd 80, D=1280)", its `launches` from (b)); the last line is {"ok":
true, "device": {...}}. The
script needs no network and no JAX, and stops every process it starts.
"""

from __future__ import annotations

import bisect
import gc
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM published peaks (dense): bf16 tensor-core rate, fp32 outside the
# tensor cores (the fp32 routes' rate), and HBM3 rate
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

SEED = 0
BATCH = 256
N_IMAGES = 1024
# Kernel vs plain twin, bf16 at 12 layers: both round every layer's output
# to bf16 (8 significant bits) but sum their fp32 products in different
# orders, so a value near a rounding boundary can land one bf16 step apart,
# and the residual stream carries that step through the later layers. At one
# layer 99.8% of the outputs are identical (ViT-Tiny shapes, H100); at 12
# layers about a third differ, by 1.3e-3 on average.
#   * the largest difference may be 4 bf16 steps at the output's largest
#     magnitude (|x| < 8: 4 * 2**-5);
#   * the mean difference may be 3e-3 (0.4 of a step at magnitude 1);
#   * the kernel must be as close to an fp32 forward of the same weights
#     and input as the plain twin is: mean error at most 5% above the twin's.
KERNEL_MAX_ABS_TOL = 0.125
KERNEL_MEAN_ABS_TOL = 3e-3
KERNEL_VS_FP32_RATIO = 1.05
# Served features (prediction-head output) through the kernel vs through the
# plain twin: relative to the features' largest magnitude.
FEATURE_REL_TOL = 2e-2
# Backward kernels vs their plain twins, one layer at B=128 (bf16): both
# round at the same points (bf16 m1, dm1, datt, dS, dqkv and outputs) but sum
# in other orders, so a value near a bf16 boundary lands one step apart. At
# the training shape the largest difference is 0.4% of the output's largest
# magnitude. Tolerances, relative to the twin's largest magnitude per output:
BWD_MAX_REL_TOL = 2e-2
BWD_MEAN_REL_TOL = 2e-3
# ... and against an fp32 backward of the same inputs the kernel's mean error
# (relative to the output's largest magnitude) may be at most 5% above the
# twin's, plus 1e-6 for outputs that both get to fp32 roundoff (bias sums of
# bf16 values).
BWD_VS_FP32_SLACK = 1e-6
# The 12-layer backward (the Function on the card vs backbone_backward_plain):
# dx crosses 12 layers in bf16, so the one-step differences compound.
BWD12_MAX_REL_TOL = 5e-2
BWD12_MEAN_REL_TOL = 5e-3
# Step 1 of training, kernels vs attn_impl="plain" (torch autograd through the
# plain bf16 forward, which rounds its gradients elsewhere): the loss within
# 1e-3 relative; Adam's first moments (0.1 x the gradient) within 10% of each
# leaf's largest magnitude and 5% in relative L2 over all leaves.
STEP_LOSS_REL_TOL = 1e-3
STEP_MU_MAX_REL_TOL = 0.1
STEP_MU_L2_REL_TOL = 5e-2
# Adam's first update is lr * g / (|g| + eps): +-lr wherever a gradient is
# nonzero, so the updated params of the two paths are equal or 2 lr apart,
# where the gradient's sign differs (a gradient near 0). At least 99% of the
# trainable params must move the same way (99.8% measured on the H100).
STEP_SAME_DIRECTION_MIN = 0.99
TRAIN_BATCH = 128
TRAIN_IMAGES = 4096  # four optimizer steps of 8 x 128
PATH_IMAGES = 2048  # two optimizer steps of each other backbone path
# The fp32-inside attention kernels vs their plain twins: both compute in
# fp32 and differ in the order of their sums only. bf16 outputs: a value near
# a rounding boundary lands one bf16 step apart, so the largest difference
# may be 1% of the output's largest magnitude (2.5 steps there) and the mean
# 1e-4 of it; fp32 outputs: 1e-5 of it.
FLASH_TOL = {torch.bfloat16: (1e-2, 1e-4), torch.float32: (1e-5, 1e-6)}
# ... and against the function computed in float64 from the same inputs:
# with bf16 outputs the kernel's mean error may be at most 5% above the
# twin's (KERNEL_VS_FP32_RATIO; an attention that rounded P or dS to bf16
# lands further away, as mha_plain shows beside it); with fp32 outputs both
# sit at fp32 roundoff of sums taken in other orders, so the kernel's mean
# error must stay under 1e-6 of the output's largest magnitude.
FLASH_FP32_VS_FP64_TOL = 1e-6
# The fp32 routes (compute_dtype=float32) vs their fp32 twins: every
# rounding point is the identity, so the two differ by float32 sums taken in
# other orders: the largest difference may be 1e-4 of the output's largest
# magnitude for one layer, 1e-3 through 12 layers (forward and backward);
# against the same function in float64 (the twins run in float64) the
# kernel's mean error may be at most 5% above the twin's plus 1e-6 of the
# largest magnitude, where both sit at fp32 roundoff.
FP32_TOL = 1e-4
FP32_TOL_12 = 1e-3
FP32_VS_FP64_SLACK = 1e-6
# Served features through the fp32 kernels vs the fp32 plain path: fp32
# roundoff through 12 layers and the heads, within 1e-4 of the features'
# largest magnitude.
FP32_FEATURE_REL_TOL = 1e-4
FP32_IMAGES = 1024  # one fp32 optimizer step of 8 x 128 per fp32 path
# The pretrained init on the card: a weight file of the HF layout written
# from seeded random weights (no checkpoint is in the repository).
PRETRAINED_SEED = 7
# The fine-tune path (phase 10b): evaluate's probabilities through the
# kernels vs the plain twin, from one state and one eval stream: both round
# the backbone at bf16 and differ as the served features do (FEATURE_REL_TOL
# of their largest magnitude, here 1), so within 2e-2 absolute; the same
# bound for the eval loss, relative.
FT_PROB_TOL = 2e-2
# Step 1 of fine-tuning in bf16 cannot be held to the SSP step's absolute
# tolerances: the BN head makes the backbone's gradient a sum of per-image
# terms that mostly cancel, so bf16 rounding moves it far. On the H100 both
# bf16 paths (the kernels and the plain twin) land ~15% (relative L2) from
# the same step taken in fp32 and ~11% from each other, while the fp32
# routes agree with the fp32 twin within 5e-5. So the bf16 kernels are held
# as close to the fp32 step as the twin is (KERNEL_VS_FP32_RATIO), the test
# every bf16 kernel passes; the fp32 step keeps the STEP_* tolerances.
# The two bf16 paths' distance from each other is held as well, on the
# blocks' first moments (what the backward kernels compute): 0.083 relative L2
# on the H100, held within FT_BLOCKS_MU_L2_TOL, which leaves the kernels no
# bf16 error of their own above ~0.056 (sqrt(0.1**2 - 0.083**2)).
FT_BLOCKS_MU_L2_TOL = 0.1
# The head's first bias feeds train-mode BN, which subtracts the batch mean:
# its true gradient is 0 and both paths hold rounding noise there.
FT_ZERO_GRAD = ("mu/1/linear_0/b",)
FT_EVAL_IMAGES = 512
FT_STEPS = 10  # warm steps timed
FT_FOLDS = 3  # `run ft-octmnist` cut from 10 folds and 50 epochs
FT_EPOCHS = 2
STAGE_CALLS = 10  # calls per traced run of a backward half's stage breakdown


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


# kernels templated on their key tiles first (then the head_dim and, for
# the backward core, its forward-only mode), and those on the head_dim
PTXAS_TILES_FIRST = ("attention_bwd_kernel", "flash_fwd_tc", "flash_bwd_rows_tc",
                     "attention_kernel")
PTXAS_HEAD_DIM_FIRST = ("flash_fwd_kernel", "flash_bwd_rows_kernel", "flash_bwd_cols_kernel",
                        "flash_bwd_cols_tc", "gl_fwd_kernel", "gl_core_kernel",
                        "gl_flash_rows_kernel", "gl_flash_cols_kernel", "long_fwd_f32_kernel",
                        "long_bwd_rows_f32_kernel", "long_bwd_cols_f32_kernel")


def ptxas_keep(base: str, ints: list, nt, head_dims: bool) -> bool:
    """Whether ptxas_report lists a kernel: by default one line per kernel,
    an attention kernel at `nt` key tiles and head_dim 64 only (the backward
    core not in its forward-only mode); with `head_dims`, every attention
    kernel at head_dim 16, 32 or 48, and the forward-only core."""
    if base in PTXAS_TILES_FIRST:
        dh, fwd = (ints[1] if len(ints) > 1 else 64), (ints[2] if len(ints) > 2 else 0)
        if head_dims:
            return dh != 64 or fwd == 1
        return ints[:1] == [nt] and dh == 64 and fwd == 0
    if base in PTXAS_HEAD_DIM_FIRST:
        dh = ints[0] if ints else 64
        return dh != 64 if head_dims else dh == 64
    return not head_dims


def ptxas_report(log: str, nt, head_dims: bool = False) -> list:
    """One line per kernel of a `ptxas -v` log: its registers and spill
    stores, the attention kernels' instantiations as ptxas_keep picks
    them."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"entry function '_Z(\d+)(\w+)'", line)
        if m:
            n = int(m.group(1))
            base, rest = m.group(2)[:n], m.group(2)[n:]
            args = re.match(r"I(.*?)E(E|v)", rest)
            ints = [int(i) for i in re.findall(r"L[a-z](\d+)E", args.group(0))] if args else []
            name = None if not ptxas_keep(base, ints, nt, head_dims) else base + (
                "<%s>" % ",".join(re.findall(r"L[a-z](\d+)E", args.group(0)) or [args.group(1)])
                if args else "")
            spill = "?"
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append(f"{name}: {m.group(1)} registers, {spill} B spill stores"
                       + (f", {smem.group(1)} B static shared memory" if smem else ""))
            name = None
    return out


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def random_backbone(gen, layers, d, mlp, dev):
    """Stacked block weights in WEIGHT_NAMES order, kernel dtypes, with
    nonzero biases and LN params so every term of the block is exercised."""
    def n(*shape, std):
        return torch.randn(*shape, generator=gen) * std

    wt = (
        1.0 + n(layers, d, std=0.1), n(layers, d, std=0.1),
        n(layers, d, 3 * d, std=0.02), n(layers, 3 * d, std=0.02),
        n(layers, d, d, std=0.02), n(layers, d, std=0.02),
        1.0 + n(layers, d, std=0.1), n(layers, d, std=0.1),
        n(layers, d, mlp, std=0.02), n(layers, mlp, std=0.02),
        n(layers, mlp, d, std=0.02), n(layers, d, std=0.02),
    )
    ln = (0, 1, 6, 7)
    return tuple(
        (t if i in ln else t.to(torch.bfloat16)).to(dev).contiguous()
        for i, t in enumerate(wt)
    )


def library_backbone(x, wt, heads, eps):
    """The same pre-LN stack from PyTorch's library calls (yardstick only)."""
    b, s, d = x.shape
    dh = d // heads
    h = x
    for l in range(wt[0].shape[0]):
        ln1s, ln1b, wqkv, bqkv, wo, bo, ln2s, ln2b, w1, b1, w2, b2 = (
            t[l] for t in wt)
        y = F.layer_norm(h, (d,), ln1s.to(h.dtype), ln1b.to(h.dtype), eps)
        qkv = torch.matmul(y, wqkv) + bqkv
        q, k, v = qkv.view(b, s, 3, heads, dh).permute(2, 0, 3, 1, 4)
        att = F.scaled_dot_product_attention(q, k, v)
        h = h + torch.matmul(att.transpose(1, 2).reshape(b, s, d), wo) + bo
        y = F.layer_norm(h, (d,), ln2s.to(h.dtype), ln2b.to(h.dtype), eps)
        h = h + torch.matmul(F.gelu(torch.matmul(y, w1) + b1), w2) + b2
    return h


def backbone_bound_ms(b, s, d, heads, mlp, layers, wt, acts=2) -> tuple:
    """Least time for one backbone forward: FLOPs over the peak of the
    weights' type (bf16 tensor cores, or fp32) vs the bytes of its inputs
    (x, weights) read once and its outputs written once (`acts` (B, S, D)
    activations in all: x and out, and x2 for the one-layer forward) over
    the memory rate. Returns (ms, "operations" | "bytes", flops)."""
    per_layer = (2 * s * d * 3 * d          # QKV
                 + 2 * 2 * s * s * d        # scores and P.V over all heads
                 + 2 * s * d * d            # Wo
                 + 2 * 2 * s * d * mlp)     # W1, W2
    flops = b * layers * per_layer
    width = wt[2].element_size()
    nbytes = acts * b * s * d * width + sum(t.numel() * t.element_size() for t in wt)
    t_ops, t_bytes = flops / peak_flops(wt[2].dtype), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def attention_stage_bound_ms(b, s, d, layers) -> tuple:
    """Least time of the forward's attention stage (csrc/layer_fwd.cuh's
    attention_kernel) over `layers` layers: each layer reads qkv once (B S
    3D bf16) and writes att once (B S D); its 4 B S^2 D FLOPs (Q K^T and P V
    over all heads) over the bf16 peak take less. Returns (ms, bound by)."""
    t_bytes = layers * b * s * 4 * d * 2 / PEAK_BYTES
    t_ops = layers * 4 * b * s * s * d / PEAK_BF16_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def attention_stage_ms(totals: dict) -> tuple:
    """(device ms, launches) of the forward attention kernel in a
    stage_breakdown's `totals`."""
    rows = [v for k, v in totals.get("kernels", {}).items() if "attention_kernel" in k]
    return sum(ms for ms, _ in rows), sum(n for _, n in rows)


def sdpa_call_ms(b, s, d, heads, dev) -> tuple:
    """(device ms per call, calls recorded) of SDPA on q, k, v laid out as
    library_backbone gives them (views of one (B, S, 3D) bf16 qkv): the
    library's time for one layer of the forward's attention stage
    (yardstick only). Over STAGE_CALLS calls, since the trace may drop a
    run's first launches: the trace's device time over the launches of its
    largest kernel."""
    gen = torch.Generator().manual_seed(SEED)
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(torch.bfloat16).to(dev)
    q, k, v = qkv.view(b, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    totals = {}
    with torch.no_grad():
        stage_breakdown(lambda: [F.scaled_dot_product_attention(q, k, v)
                                 for _ in range(STAGE_CALLS)], totals=totals)
    if not totals.get("kernels"):
        return float("nan"), 0
    n = max(totals["kernels"].values())[1]
    return totals["device"] / n, n


# Host time inside the profiler's window on each side of the traced calls.
# The window is kept on the host's clock and each kernel's stamp on the
# card's, and on the H100 a stamp fell up to 1.6 ms before the host range
# that launched it (tools/trace_window_probe.py): traced unpadded, 1 of 200
# short traces lost 6 of its 10 kernels (and one of phase 19 (b)'s, in a
# whole run, all 10); padded by this much, 200 of 200 kept every kernel.
TRACE_PAD_S = 0.02


def stage_breakdown(fn, what: str = "one backbone forward", top: int = 14,
                    wrappers: tuple = (), rest: str = "", totals: dict = None) -> list:
    """Device time by CUDA kernel name over one call of `fn`, from
    torch.profiler (CUPTI), and, for each name in `wrappers`, the device
    time of the kernels that ran inside that wrapper's `vit2spn::<name>`
    range on the card's timeline (`rest` names what runs outside them);
    says so when the trace holds no device time. Sums every device event of
    the trace (prof.events()); the calls run TRACE_PAD_S inside the trace's
    window on each side. `totals`, when given, receives the device ms
    ("device") and each wrapper's ("vit2spn::<name>")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(TRACE_PAD_S)
    by_name, kernels, ranges = {}, [], []
    for ev in prof.events():
        if getattr(ev, "device_type", None) != DeviceType.CUDA:
            continue  # host ranges, not device work
        t = ev.time_range
        if ev.name.startswith("vit2spn::"):  # a wrapper's range, mirrored on the card
            ranges.append((ev.name, t.start, t.end))
            continue
        kernels.append((t.start, t.elapsed_us()))
        row = by_name.setdefault(ev.name, [0.0, 0])
        row[0] += t.elapsed_us()
        row[1] += 1
    if not kernels:
        return ["[profile] the trace holds no device time: not measured"]
    total = sum(us for us, _ in by_name.values())
    out = [f"[profile] {what}: {total / 1e3:.3f} ms device time "
           f"in {len(kernels)} kernel launches"]
    # one stream: a kernel that starts inside a wrapper's range is its own
    kernels.sort()
    starts = [k[0] for k in kernels]
    spans = {f"vit2spn::{n}": [0.0, 0] for n in wrappers}
    for name, t0, t1 in ranges:
        if name in spans:
            lo, hi = bisect.bisect_left(starts, t0), bisect.bisect_right(starts, t1)
            spans[name][0] += sum(us for _, us in kernels[lo:hi])
            spans[name][1] += 1
    for name, (us, n) in spans.items():
        out.append(f"[profile]   wrapper {name:22s} {us / 1e3:9.3f} ms "
                   f"{100 * us / total:5.1f}% ({n} calls)")
    if totals is not None:
        totals["device"] = total / 1e3
        totals.update({name: us / 1e3 for name, (us, _) in spans.items()})
        totals["kernels"] = {k: (us / 1e3, n) for k, (us, n) in by_name.items()}
    if spans:
        outside = total - sum(us for us, _ in spans.values())
        out.append(f"[profile]   {'outside the wrappers':30s} {outside / 1e3:9.3f} ms "
                   f"{100 * outside / total:5.1f}% ({rest})")
    for key, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        out.append(f"[profile]   {us / 1e3:8.3f} ms {100 * us / total:5.1f}% "
                   f"x{n:<4d} {key[:90]}")
    return out


def rel_err(a, b) -> tuple:
    """(max, mean) of |a - b| over the largest |b|."""
    diff = (a.float() - b.float()).abs()
    scale = float(b.float().abs().max()) or 1.0
    return float(diff.max()) / scale, float(diff.mean()) / scale


def check_layer_bwd(tag, fb, x, dy, w, heads, eps, fast, against_fp32):
    """Both backward halves of one layer, kernel vs plain twin (and, with
    `against_fp32`, both vs an fp32 backward). Returns each half's largest
    absolute difference."""
    worst = {}
    w32 = {n: t.float() for n, t in w.items()}
    halves = (
        ("mlp_bwd", fb.MLP_NAMES,
         lambda: fb.mlp_bwd(x, dy, w, eps, fast),
         lambda: fb.mlp_bwd_plain(x, dy, w, eps, fast),
         lambda: fb.mlp_bwd_plain(x.float(), dy.float(), w32, eps, fast)),
        ("attn_bwd", fb.ATTN_NAMES,
         lambda: fb.attn_bwd(x, dy, w, heads, eps),
         lambda: fb.attn_bwd_plain(x, dy, w, heads, eps),
         lambda: fb.attn_bwd_plain(x.float(), dy.float(), w32, heads, eps)),
    )
    for name, names, kernel, twin, fp32 in halves:
        got = kernel()
        torch.cuda.synchronize()
        ref = twin()
        ref32 = fp32() if against_fp32 else None
        outs = [("dx", got[0], ref[0], None if ref32 is None else ref32[0])]
        outs += [(n, got[1][n], ref[1][n], None if ref32 is None else ref32[1][n])
                 for n in names]
        worst_rel = 0.0
        for n, a, b, c in outs:
            mx_rel, mean_rel = rel_err(a, b)
            worst[name] = max(worst.get(name, 0.0),
                              float((a.float() - b.float()).abs().max()))
            worst_rel = max(worst_rel, mx_rel)
            if not (mx_rel <= BWD_MAX_REL_TOL and mean_rel <= BWD_MEAN_REL_TOL):
                raise AssertionError(f"{name} disagrees with its plain twin ({tag}, {n}: "
                                     f"max {mx_rel:.3g}, mean {mean_rel:.3g} relative)")
            if c is not None:
                e_k, e_t = rel_err(a, c)[1], rel_err(b, c)[1]
                if not e_k <= KERNEL_VS_FP32_RATIO * e_t + BWD_VS_FP32_SLACK:
                    raise AssertionError(f"{name} is less accurate than its plain twin "
                                         f"({tag}, {n}: {e_k:.3g} vs {e_t:.3g})")
        log(f"[{name}-vs-plain] {tag}: largest relative difference {worst_rel:.3g} "
            f"over dx and {len(names)} weight gradients (tol max {BWD_MAX_REL_TOL}, "
            f"mean {BWD_MEAN_REL_TOL}){'; vs fp32 within the twin' if c is not None else ''}")
    return worst


def check_fp32_layer(tag, fb, x, x2, dy, w, heads, eps, fast, tol=FP32_TOL) -> dict:
    """The fp32 routes of the four one-layer kernels (layer_fwd, mlp_bwd,
    attn_bwd, merged_bwd) against their fp32 twins (largest difference
    within `tol` of each output's largest magnitude) and against the same
    twins run in float64 (mean error at most 5% above the fp32 twin's, plus
    FP32_VS_FP64_SLACK). x, x2, dy fp32; w one layer's weights by name.
    Returns each kernel's largest absolute difference from its twin."""
    w32 = {n: t.float() for n, t in w.items()}
    w64 = {n: t.double() for n, t in w.items()}
    x64, x264, dy64 = x.double(), x2.double(), dy.double()
    wt32 = tuple(w32[n] for n in fb.WEIGHT_NAMES)
    wt64 = tuple(w64[n] for n in fb.WEIGHT_NAMES)

    def flat(out, names):
        return [out[0], *[out[1][n] for n in names]]

    cases = (
        ("layer_fwd", ("out", "x2"),
         lambda: fb.layer_fwd(x, wt32, heads, eps, fast),
         lambda: fb.layer_forward_plain(x, wt32, heads, eps, fast),
         lambda: fb.layer_forward_plain(x64, wt64, heads, eps, fast)),
        ("mlp_bwd", ("dx2",) + fb.MLP_NAMES,
         lambda: flat(fb.mlp_bwd(x2, dy, w32, eps, fast), fb.MLP_NAMES),
         lambda: flat(fb.mlp_bwd_plain(x2, dy, w32, eps, fast), fb.MLP_NAMES),
         lambda: flat(fb.mlp_bwd_plain(x264, dy64, w64, eps, fast), fb.MLP_NAMES)),
        ("attn_bwd", ("dx",) + fb.ATTN_NAMES,
         lambda: flat(fb.attn_bwd(x, dy, w32, heads, eps), fb.ATTN_NAMES),
         lambda: flat(fb.attn_bwd_plain(x, dy, w32, heads, eps), fb.ATTN_NAMES),
         lambda: flat(fb.attn_bwd_plain(x64, dy64, w64, heads, eps), fb.ATTN_NAMES)),
        ("merged_bwd", ("dx",) + fb.WEIGHT_NAMES,
         lambda: flat(fb.merged_bwd(x, x2, dy, w32, heads, eps, fast), fb.WEIGHT_NAMES),
         lambda: flat(fb.merged_bwd_plain(x, x2, dy, w32, heads, eps, fast), fb.WEIGHT_NAMES),
         lambda: flat(fb.merged_bwd_plain(x64, x264, dy64, w64, heads, eps, fast),
                      fb.WEIGHT_NAMES)),
    )
    worst = {}
    for name, names, kernel, twin, ref64 in cases:
        before = getattr(fb, name).launches
        got = kernel()
        torch.cuda.synchronize()
        if getattr(fb, name).launches != before + 1:
            raise AssertionError(f"{name} fp32 did not launch its kernel ({tag})")
        worst[name] = check_fp32_outputs(f"{name}-fp32", tag, names, got, twin(), ref64(), tol)
    return worst


def check_fp32_outputs(what, tag, names, got, ref, ref64, tol) -> float:
    """fp32 outputs against the fp32 twin's and the float64 twin's (see
    check_fp32_layer). Returns the largest absolute difference."""
    worst, worst_rel, ratio = 0.0, 0.0, 0.0
    for n, a, b, c in zip(names, got, ref, ref64):
        if a.dtype != torch.float32:
            raise AssertionError(f"{what} gave {n} in {a.dtype} ({tag})")
        mx_rel = rel_err(a, b)[0]
        if not mx_rel <= tol:
            raise AssertionError(f"{what} disagrees with its fp32 twin ({tag}, {n}: "
                                 f"{mx_rel:.3g} of the largest magnitude, tol {tol})")
        e_k, e_t = mean_rel64(a, c.double()), mean_rel64(b, c.double())
        if not e_k <= KERNEL_VS_FP32_RATIO * e_t + FP32_VS_FP64_SLACK:
            raise AssertionError(f"{what} is less accurate than its fp32 twin against float64 "
                                 f"({tag}, {n}: {e_k:.3g} vs {e_t:.3g})")
        worst = max(worst, float((a - b).abs().max()))
        worst_rel = max(worst_rel, mx_rel)
        ratio = max(ratio, e_k / e_t if e_t else 0.0)
    log(f"[{what}-vs-plain] {tag}: largest relative difference {worst_rel:.3g} over "
        f"{len(names)} outputs (tol {tol}); mean error vs float64 at most {ratio:.3f}x the "
        f"fp32 twin's (tol {KERNEL_VS_FP32_RATIO}x + {FP32_VS_FP64_SLACK})")
    return worst


def layer_weights(names, wt):
    """Layer 0 of stacked block weights, by name."""
    return {n: t[0] for n, t in zip(names, wt)}


def library_mlp_half(x2, dout, w, eps):
    """The MLP half's recompute and backward from PyTorch's library calls
    (yardstick only): torch autograd of F.layer_norm, torch.matmul, F.gelu."""
    leaves = [t.detach().requires_grad_(True) for t in
              (x2, w["ln2_scale"], w["ln2_bias"], w["w1"], w["b1"], w["w2"], w["b2"])]
    xx, s_, b_, w1, b1, w2, b2 = leaves
    d = xx.shape[-1]
    y = F.layer_norm(xx, (d,), s_.to(xx.dtype), b_.to(xx.dtype), eps)
    out = xx + torch.matmul(F.gelu(torch.matmul(y, w1) + b1), w2) + b2
    return torch.autograd.grad(out, leaves, dout)


def library_attn_half(x, dx2, w, heads, eps):
    """The attention half's recompute and backward from PyTorch's library
    calls (yardstick only): torch autograd of F.layer_norm, torch.matmul and
    SDPA."""
    leaves = [t.detach().requires_grad_(True) for t in
              (x, w["ln1_scale"], w["ln1_bias"], w["wqkv"], w["bqkv"], w["wo"], w["bo"])]
    xx, s_, b_, wqkv, bqkv, wo, bo = leaves
    b, s, d = xx.shape
    y = F.layer_norm(xx, (d,), s_.to(xx.dtype), b_.to(xx.dtype), eps)
    q, k, v = (torch.matmul(y, wqkv) + bqkv).view(b, s, 3, heads, d // heads).permute(
        2, 0, 3, 1, 4)
    att = F.scaled_dot_product_attention(q, k, v)
    out = xx + torch.matmul(att.transpose(1, 2).reshape(b, s, d), wo) + bo
    return torch.autograd.grad(out, leaves, dx2)


def peak_flops(dtype) -> float:
    return PEAK_FP32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS


def bwd_bound_ms(kind, b, s, d, heads, mlp, w) -> tuple:
    """Least time for one layer's backward half ("mlp", "attn") or whole
    backward ("merged") at batch b: the FLOPs the function needs (the
    recompute of what its inputs do not hold included, each product once)
    over the bf16 peak, vs its inputs read once (x, x2 and the incoming
    gradient in bf16, the weights) and its outputs written once (dx in bf16,
    fp32 weight gradients) over the memory rate. Returns (ms, "operations" |
    "bytes", flops)."""
    if kind == "merged":
        mlp_flops = bwd_bound_ms("mlp", b, s, d, heads, mlp, w)[2]
        attn_flops = bwd_bound_ms("attn", b, s, d, heads, mlp, w)[2]
        flops = mlp_flops + attn_flops
        grads = sum(t.numel() for t in w.values())
        nbytes = (4 * b * s * d * w["w1"].element_size()
                  + sum(t.numel() * t.element_size() for t in w.values()) + 4 * grads)
        t_ops, t_bytes = flops / peak_flops(w["w1"].dtype), nbytes / PEAK_BYTES
        return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops
    if kind == "mlp":
        names = ("ln2_scale", "ln2_bias", "w1", "b1", "w2")
        # m1 recompute, dout W2^T, dW2, dW1, dm1 W1^T
        flops = b * 5 * 2 * s * d * mlp
        grads = 2 * d + d * mlp + mlp + mlp * d + d
    else:
        names = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo")
        # qkv recompute, dWqkv and dqkv Wqkv^T; datt and dWo; attention:
        # Q K^T and P V (recompute), dP, dV, dQ, dK
        flops = b * (3 * 2 * s * d * 3 * d + 2 * 2 * s * d * d + 6 * 2 * s * s * d)
        grads = 2 * d + 3 * d * d + 3 * d + d * d + d
    nbytes = (3 * b * s * d * w[names[2]].element_size()
              + sum(w[n].numel() * w[n].element_size() for n in names) + 4 * grads)
    t_ops, t_bytes = flops / peak_flops(w[names[2]].dtype), nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def kernel_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name."""
    from vit2spn_tpu_torch.ops import flash_attention as fa
    from vit2spn_tpu_torch.ops import fused_block as fb

    return {"backbone_fwd": fb.fused_backbone, "layer_fwd": fb.layer_fwd,
            "mlp_bwd": fb.mlp_bwd, "attn_bwd": fb.attn_bwd, "merged_bwd": fb.merged_bwd,
            "flash_fwd": fa.flash_fwd, "flash_bwd": fa.flash_bwd}


def reset_launches() -> None:
    from vit2spn_tpu_torch.ops.fused_block import LONG_SEQ_LAUNCHES

    for fn in kernel_counters().values():
        fn.launches = 0
    for route in LONG_SEQ_LAUNCHES:
        LONG_SEQ_LAUNCHES[route] = 0


def read_launches() -> dict:
    """Each wrapper's calls, and the launches of each long-sequence route
    (S > 256, csrc/long_attention.cuh) as "<route> (S>256)"."""
    from vit2spn_tpu_torch.ops.fused_block import LONG_SEQ_LAUNCHES

    return {**{name: fn.launches for name, fn in kernel_counters().items()},
            **{f"{route} (S>256)": n for route, n in LONG_SEQ_LAUNCHES.items()}}


def attention_fp64(q, k, v, do):
    """Attention and its backward computed in float64 on the card, from the
    inputs as they are (the reference the fp32-inside kernels and their
    twins are both held against). Returns (o, dq, dk, dv)."""
    q, k, v, do = (t.double() for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * scale, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v)
    ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    return o, dq, dk, dv


def mean_rel64(a, ref) -> float:
    """mean |a - ref| over the largest |ref|, in float64."""
    return float((a.double() - ref).abs().mean()) / (float(ref.abs().max()) or 1.0)


def flash_operands(gen, b, s, heads, dtype, dev, dh=64):
    """q, k, v as the per-op block hands them to attention (views of one
    (B, S, 3D) qkv, read in place; head_dim dh) and an output gradient."""
    d = heads * dh
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(dtype).to(dev)
    q, k, v = (t.reshape(b, s, heads, dh) for t in qkv.split(d, dim=-1))
    do = (0.1 * torch.randn(b, s, heads, dh, generator=gen)).to(dtype).to(dev)
    return q, k, v, do


def check_flash(tag, q, k, v, do) -> dict:
    """Both flash kernels against their plain twins and against float64.
    Returns the largest absolute difference of each kernel from its twin."""
    from vit2spn_tpu_torch.ops import flash_attention as fa
    from vit2spn_tpu_torch.ops.attention import mha_plain

    got = (fa.flash_fwd(q, k, v), *fa.flash_bwd(q, k, v, do))
    torch.cuda.synchronize()
    ref = (fa.flash_attention_plain(q, k, v), *fa.flash_attention_bwd_plain(q, k, v, do))
    ref64 = attention_fp64(q, k, v, do)
    max_tol, mean_tol = FLASH_TOL[q.dtype]
    worst, errs = {"flash_fwd": 0.0, "flash_bwd": 0.0}, []
    for name, a, b, c in zip(("o", "dq", "dk", "dv"), got, ref, ref64):
        mx, mean = rel_err(a, b)
        if not (mx <= max_tol and mean <= mean_tol):
            raise AssertionError(f"flash kernel disagrees with its plain twin ({tag}, {name}: "
                                 f"max {mx:.3g}, mean {mean:.3g} relative)")
        e_k, e_t = mean_rel64(a, c), mean_rel64(b, c)
        ok = (e_k <= KERNEL_VS_FP32_RATIO * e_t if q.dtype == torch.bfloat16
              else e_k <= FLASH_FP32_VS_FP64_TOL)
        if not ok:
            raise AssertionError(f"flash kernel is further from float64 than its twin "
                                 f"({tag}, {name}: {e_k:.4g} vs {e_t:.4g})")
        key = "flash_fwd" if name == "o" else "flash_bwd"
        worst[key] = max(worst[key], float((a.float() - b.float()).abs().max()))
        errs.append(f"{name} {mx:.3g}/{e_k:.3g}/{e_t:.3g}")
    line = (f"[flash-vs-plain] {tag}: largest relative difference / mean error vs float64 "
            f"kernel / twin: {', '.join(errs)} (tol {max_tol}, {mean_tol}; ")
    line += ("ratio %s)" % KERNEL_VS_FP32_RATIO if q.dtype == torch.bfloat16
             else "%g)" % FLASH_FP32_VS_FP64_TOL)
    if q.dtype == torch.bfloat16:  # what rounding P to bf16 would cost
        line += f"; mha_plain (bf16 P) {mean_rel64(mha_plain(q, k, v), ref64[0]):.3g}"
    log(line)
    return worst


def check_layer_fwd(tag, fb, x, w, heads, eps, fast, against_fp32=True) -> float:
    """The one-layer forward kernel against `layer_forward_plain` (out and
    x2), and (`against_fp32`) as close to an fp32 layer as the twin. Returns
    the largest absolute difference."""
    got = fb.layer_fwd(x, w, heads, eps, fast)
    torch.cuda.synchronize()
    ref = fb.layer_forward_plain(x, w, heads, eps, fast)
    ref32 = fb.layer_forward_plain(x.float(), tuple(t.float() for t in w), heads, eps, fast)
    worst = 0.0
    for name, a, b, c in zip(("out", "x2"), got, ref, ref32):
        diff = (a.float() - b.float()).abs()
        mx, mean = float(diff.max()), float(diff.mean())
        e_k, e_t = float((a.float() - c).abs().mean()), float((b.float() - c).abs().mean())
        log(f"[layer_fwd-vs-plain] {tag} {name}: max_abs_err {mx:.6g} mean_abs_err "
            f"{mean:.3g}; vs fp32 kernel {e_k:.6g}, twin {e_t:.6g} (tol max "
            f"{KERNEL_MAX_ABS_TOL}, mean {KERNEL_MEAN_ABS_TOL}, ratio {KERNEL_VS_FP32_RATIO})")
        if not (mx <= KERNEL_MAX_ABS_TOL and mean <= KERNEL_MEAN_ABS_TOL):
            raise AssertionError(f"layer kernel disagrees with its plain twin ({tag}, {name})")
        if against_fp32 and not e_k <= KERNEL_VS_FP32_RATIO * e_t:
            raise AssertionError(f"layer kernel is less accurate than its twin ({tag}, {name})")
        worst = max(worst, mx)
    return worst


def check_backbone_fwd(tag, fb, x, wt, heads, eps, fast, tol=None) -> float:
    """The backbone forward kernel against `backbone_forward_plain` at a wide
    route's width (phase 14 (a)), with and without the emit_res stacks:
    max and mean differences within `tol` (ZOO_FWD_REL_TOL by default) of
    the twin's largest magnitude, and the kernel's output as close to an
    fp32 forward of the same weights as the twin's (KERNEL_VS_FP32_RATIO),
    at every shape. Returns the largest absolute difference."""
    max_tol, mean_tol = tol or ZOO_FWD_REL_TOL
    worst = 0.0
    ref32 = fb.backbone_forward_plain(x.float(), tuple(t.float() for t in wt), heads, eps, fast)
    for emit in (False, True):
        got = fb.fused_backbone(x, wt, heads, eps, fast, emit)
        torch.cuda.synchronize()
        ref = fb.backbone_forward_plain(x, wt, heads, eps, fast, emit)
        got, ref = (got, ref) if emit else ((got,), (ref,))
        for name, a, b in zip(("out", "xs", "x2s"), got, ref):
            mx, mean = rel_err(a, b)
            big = float(b.float().abs().max())
            log(f"[backbone_fwd-vs-plain] {tag} emit_res={emit} {name}: max_abs_err "
                f"{mx * big:.6g} mean_abs_err {mean * big:.3g}, relative to max |ref| {big:.4g}: "
                f"{mx:.3g} / {mean:.3g} (tol {max_tol}, {mean_tol})")
            if not (mx <= max_tol and mean <= mean_tol):
                raise AssertionError(f"backbone kernel disagrees with its twin ({tag}, {name})")
            worst = max(worst, mx * big)
        e_k = float((got[0].float() - ref32).abs().mean())
        e_t = float((ref[0].float() - ref32).abs().mean())
        log(f"[backbone_fwd-vs-fp32] {tag} emit_res={emit}: mean_abs_err kernel {e_k:.6g}, "
            f"twin {e_t:.6g} (tol ratio {KERNEL_VS_FP32_RATIO})")
        if not e_k <= KERNEL_VS_FP32_RATIO * e_t:
            raise AssertionError(f"backbone kernel is less accurate than its twin ({tag})")
    return worst


def equal_bits(a, b) -> float:
    """The share of elements of two tensors of one dtype that are equal bit
    for bit: exactly 1.0 when every element is (counted in integers: a float
    mean of the matches can read 1 - 2^-24 for some sizes, as torch's mean
    multiplies by 1/N)."""
    ia = a.contiguous().view(torch.int16 if a.element_size() == 2 else torch.int32)
    ib = b.contiguous().view(torch.int16 if b.element_size() == 2 else torch.int32)
    return 1.0 - int((ia != ib).sum()) / ia.numel()


def check_merged_bwd(tag, fb, x, x2, dy, w, heads, eps, fast, equal) -> float:
    """The merged layer backward against the split kernels (the share of
    equal bits, which must be 100% with `equal`, and the split tolerances)
    and against `merged_bwd_plain` (and as close to an fp32 backward as it).
    Returns the largest absolute difference from the twin."""
    dx, grads = fb.merged_bwd(x, x2, dy, w, heads, eps, fast)
    torch.cuda.synchronize()
    dx2, mgrads = fb.mlp_bwd(x2, dy, w, eps, fast)
    sdx, sgrads = fb.attn_bwd(x, dx2, w, heads, eps)
    sgrads = {**mgrads, **sgrads}
    rdx, rgrads = fb.merged_bwd_plain(x, x2, dy, w, heads, eps, fast)
    w32 = {n: t.float() for n, t in w.items()}
    fdx, fgrads = fb.merged_bwd_plain(x.float(), x2.float(), dy.float(), w32, heads, eps, fast)
    worst, worst_rel, shares = 0.0, 0.0, []
    for n in ("dx",) + fb.WEIGHT_NAMES:
        a, s_, b, c = ((dx, sdx, rdx, fdx) if n == "dx"
                       else (grads[n], sgrads[n], rgrads[n], fgrads[n]))
        shares.append(equal_bits(a, s_))
        for ref, what in ((b, "its plain twin"), (s_, "the split kernels")):
            mx_rel, mean_rel = rel_err(a, ref)
            if not (mx_rel <= BWD_MAX_REL_TOL and mean_rel <= BWD_MEAN_REL_TOL):
                raise AssertionError(f"merged_bwd disagrees with {what} ({tag}, {n}: max "
                                     f"{mx_rel:.3g}, mean {mean_rel:.3g} relative)")
        e_k, e_t = rel_err(a, c)[1], rel_err(b, c)[1]
        if not e_k <= KERNEL_VS_FP32_RATIO * e_t + BWD_VS_FP32_SLACK:
            raise AssertionError(f"merged_bwd is less accurate than its twin ({tag}, {n})")
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        worst_rel = max(worst_rel, rel_err(a, b)[0])
    log(f"[merged_bwd-vs-plain] {tag}: largest relative difference {worst_rel:.3g} over dx "
        f"and 12 weight gradients (tol max {BWD_MAX_REL_TOL}, mean {BWD_MEAN_REL_TOL}); vs "
        f"fp32 within the twin; equal bits with the split kernels: "
        f"{100.0 * min(shares):.4f}% (least over the 13 outputs"
        + ("; must be 100%: the same stages and orders of sums)" if equal else ")"))
    if equal and min(shares) != 1.0:
        raise AssertionError(f"merged_bwd differs from the split kernels bit for bit ({tag})")
    return worst


def time_gemm_f32(fb, m, d, mlp, gen, dev) -> None:
    """The fp32 GEMM that every fp32 route runs, alone, at the backward's
    shapes over m token rows, against torch.matmul in fp32 (TF32 off): C = A
    B and C = A B^T at (N, K) = (3 d, d), (d, d), (mlp, d), (d, mlp), and the
    weight-gradient form [A | 1]^T B with the token rows split (C's last row
    B's column sums) at (K1, N) = (d, 3 d), (d, d), (d, mlp), (mlp, d). Each
    within FP32_TOL of the largest magnitude of torch's result."""
    lib = fb._load("mlp_bwd")
    stream = torch.cuda.current_stream().cuda_stream

    def rnd(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    cases = []
    for form, (n, k) in ((0, (3 * d, d)), (1, (d, d)), (0, (mlp, d)), (1, (d, mlp))):
        a, b = rnd(m, k), rnd(*((k, n) if form == 0 else (n, k)))
        c = torch.empty(m, n, device=dev)
        lib_fn = (lambda a=a, b=b: a @ b) if form == 0 else (lambda a=a, b=b: a @ b.t())
        cases.append((("A B", "A B^T")[form], form, m, n, k, a, b, c, None, lib_fn))
    for k1, n in ((d, 3 * d), (d, d), (d, mlp), (mlp, d)):
        a, b = rnd(m, k1), rnd(m, n)
        c = torch.empty(k1 + 1, n, device=dev)
        ws = torch.empty(lib.vit2spn_gemm_f32_workspace_floats(k1, n, m), device=dev)
        lib_fn = (lambda a=a, b=b: torch.cat([a.t() @ b, b.sum(0, keepdim=True)]))
        cases.append(("[A|1]^T B", 2, k1, n, m, a, b, c, ws, lib_fn))
    for what, form, mm, n, k, a, b, c, ws, lib_fn in cases:
        def kernel(a=a, b=b, c=c, ws=ws, mm=mm, n=n, k=k, form=form):
            fb._raise_on(lib, lib.vit2spn_gemm_f32(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                                   None if ws is None else ws.data_ptr(),
                                                   mm, n, k, form, stream), "fp32 GEMM")
        kernel()
        torch.cuda.synchronize()
        ref = lib_fn()
        err = rel_err(c, ref)[0]
        k_ms, l_ms = time_ms(kernel), time_ms(lib_fn)
        flops = 2.0 * mm * n * k
        log(f"[time] fp32 GEMM {what} M={mm} N={n} K={k}: kernel {k_ms:.4f} ms "
            f"({flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s), torch.matmul {l_ms:.4f} ms "
            f"({flops / (l_ms * 1e-3) / 1e12:.1f} TFLOP/s); largest difference {err:.3g} of "
            f"the largest magnitude (tol {FP32_TOL})")
        if not err <= FP32_TOL:
            raise AssertionError(f"the fp32 GEMM disagrees with torch.matmul ({what}, N={n})")


def rel_l2(a: dict, b: dict, keys) -> float:
    """Relative L2 distance of a's leaves from b's over `keys`, in float64."""
    num = sum(np.sum((a[k].astype(np.float64) - b[k]) ** 2) for k in keys)
    den = sum(np.sum(b[k].astype(np.float64) ** 2) for k in keys)
    return math.sqrt(num / den)


def compare_steps(tag, names, runs, eps_lr, params, stats=(), skip=(),
                  mu_max_tol=STEP_MU_MAX_REL_TOL, loss=True) -> None:
    """Step 1 of two paths from one state. `runs` holds (loss, flat state
    before, flat state after) per path, path first; `params` the prefixes of
    the trainable leaves, `stats` those of running statistics. The loss
    within STEP_LOSS_REL_TOL; Adam's first moments and each statistic's move
    within STEP_MU_MAX_REL_TOL of the leaf's largest and STEP_MU_L2_REL_TOL
    in relative L2; the updated params moved the same way in at least
    STEP_SAME_DIRECTION_MIN of the elements, none by more than the lr.
    Moments of the leaves in `skip` (whose true gradient is 0, so both
    paths hold rounding noise there) are not compared. `mu_max_tol=None`
    holds the moments in relative L2 only (a bf16 fine-tune step, whose BN
    head makes some leaves' gradients sums that cancel). `loss=False` leaves
    the loss to the caller (two paths that round at other points)."""
    (lf, before, af), (lp, before_p, ap) = runs
    assert all(np.array_equal(before[k], before_p[k]) for k in before)
    if loss and not (np.isfinite(lf) and abs(lf - lp) <= STEP_LOSS_REL_TOL * abs(lp)):
        raise AssertionError(f"step 1 loss: {names[0]} {lf} vs {names[1]} {lp}")

    def moved(keys, delta):
        worst, num, den = 0.0, 0.0, 0.0
        for k in keys:
            a, b = delta(af, k), delta(ap, k)
            scale = np.abs(b).max()
            if scale > 0:
                worst = max(worst, np.abs(a - b).max() / scale)
            num += np.sum((a - b) ** 2)
            den += np.sum(b ** 2)
        return worst, math.sqrt(num / den)

    mu = [k for k in af if k.startswith("opt_state/") and "/mu/" in k
          and not k.endswith(skip)]
    worst, l2 = moved(mu, lambda st, k: st[k].astype(np.float64))
    # updated params: both moved by Adam's first step (|update| <= lr) from
    # the same state; the share of elements that moved the same way
    same = total = 0
    for k in af:
        if k.startswith(params):
            da, db = af[k] - before[k], ap[k] - before[k]
            lim = eps_lr * (1 + 1e-3) + 1e-7  # Adam's first step, fp32 rounding
            if np.abs(da).max() > lim or np.abs(db).max() > lim:
                raise AssertionError(f"{k}: a step larger than the learning rate")
            same += int(np.sum(np.sign(da) == np.sign(db)))
            total += da.size
    line = (f"[{tag}-{names[0].replace(' ', '-')}-vs-{names[1].replace(' ', '-')}] loss "
            f"{names[0]} {lf:.6f} {names[1]} {lp:.6f}; Adam first moments: "
            f"largest difference {worst:.3g} of the leaf's largest, relative L2 {l2:.3g} "
            f"(tol {mu_max_tol}, {STEP_MU_L2_REL_TOL}); trainable params moved "
            f"the same way in {100.0 * same / total:.2f}% of {total} elements (tol "
            f"{100.0 * STEP_SAME_DIRECTION_MIN:.0f}%)")
    s_worst = s_l2 = 0.0
    if stats:  # running statistics: their move from the shared start
        s_worst, s_l2 = moved([k for k in af if k.startswith(stats) and af[k].dtype.kind == "f"],
                              lambda st, k: st[k].astype(np.float64) - before[k])
        line += (f"; running statistics' move: largest difference {s_worst:.3g}, relative "
                 f"L2 {s_l2:.3g}")
    log(line)
    if not ((mu_max_tol is None or worst <= mu_max_tol) and l2 <= STEP_MU_L2_REL_TOL):
        raise AssertionError(f"step 1 gradients of {names[0]} disagree with {names[1]}")
    if not (s_worst <= STEP_MU_MAX_REL_TOL and s_l2 <= STEP_MU_L2_REL_TOL):
        raise AssertionError(f"step 1 running statistics of {names[0]} disagree with "
                             f"{names[1]}")
    if not same >= STEP_SAME_DIRECTION_MIN * total:
        raise AssertionError(f"step 1 updated params of {names[0]} disagree with {names[1]}")


def path_name(impl, merged, cfg) -> str:
    return f"{impl}{' merged' if merged else ''}{' fp32' if cfg.compute_dtype == 'float32' else ''}"


def step_check(cfg, images, eps_lr, path=("fused", False), ref=("plain", False), loss=True):
    """SSP step 1 from the same initial state through `path` and through the
    reference path `ref`, each (attn_impl, merged backward): loss (unless
    `loss` is False: compare_steps), Adam's first moments, updated params.
    One trainer, its state restored on the card before each path."""
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), device="cuda")
    start = state_copy(tr.state)
    before = ckpt._flatten(tr.state)
    out = []
    for impl, merged in (path, ref):
        os.environ["VIT2SPN_MERGED_BWD"] = "1" if merged else "0"
        tr.state = start
        use_path(tr, cfg, impl)
        value = float(tr.train_step(images, (0, 0))["loss"])
        out.append((value, before, ckpt._flatten(tr.state)))
    os.environ["VIT2SPN_MERGED_BWD"] = "0"
    del tr, start
    torch.cuda.empty_cache()
    compare_steps("step1", [path_name(*p, cfg) for p in (path, ref)], out, eps_lr,
                  ("params/online/", "params/heads/"), loss=loss)


def pretrained_state(vit) -> dict:
    """HF-named ViT-Tiny weights (numpy) from a seeded random backbone: the
    stand-in for the published checkpoint, which is not in the repository."""
    from vit2spn_tpu_torch.models import hf_convert
    from vit2spn_tpu_torch.models.vit import init_vit

    params = init_vit(torch.Generator().manual_seed(PRETRAINED_SEED), vit, device="cpu")
    return hf_convert.convert_to_hf_state_dict(params, vit)


def check_pretrained_init(cfg, dev) -> None:
    """SSPTrainer with pretrained_init and $VIT2SPN_VIT_TINY_PATH at an .npz
    of HF-named ViT-Tiny weights this script writes from a seeded random
    backbone (no checkpoint is in the repository): the trainer must record
    "pretrained" and start every online and target backbone on the card from
    the file's weights, exactly."""
    import tempfile

    from vit2spn_tpu_torch.models import hf_convert
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    def numpy_tree(t):
        return ({k: numpy_tree(v) for k, v in t.items()} if isinstance(t, dict)
                else t.detach().cpu().numpy())

    state = pretrained_state(cfg.vit)
    want = hf_convert.convert_hf_state_dict(state, cfg.vit)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "vit_tiny.npz")
        np.savez(path, **state)
        old = os.environ.get("VIT2SPN_VIT_TINY_PATH")
        os.environ["VIT2SPN_VIT_TINY_PATH"] = path
        try:
            tr = SSPTrainer(replace_cfg(cfg, pretrained_init=True),
                            logger=MetricLogger(echo=False), device="cuda")
        finally:
            if old is None:
                del os.environ["VIT2SPN_VIT_TINY_PATH"]
            else:
                os.environ["VIT2SPN_VIT_TINY_PATH"] = old
    n_leaves = 0
    for net_name, net in (("online", tr.params.online), ("target", tr.params.target)):
        got = numpy_tree(net)

        def walk(g, w, key):
            nonlocal n_leaves
            if isinstance(w, dict):
                for k in w:
                    walk(g[k], w[k], f"{key}/{k}")
                return
            for i in range(g.shape[0]):  # every stream
                if not np.array_equal(g[i], w):
                    raise AssertionError(f"pretrained init: {net_name}{key} differs from the "
                                         "weight file")
            n_leaves += 1

        walk(got, want, "")
    if tr.init_provenance != "pretrained" or tr.params.online["blocks"]["w1"].device != dev:
        raise AssertionError(f"pretrained init: provenance {tr.init_provenance!r}")
    log(f"[pretrained] SSPTrainer with VIT2SPN_VIT_TINY_PATH at an HF-named .npz (seed "
        f"{PRETRAINED_SEED}): init_provenance {tr.init_provenance!r}; {n_leaves} backbone "
        f"leaves of the online and target nets on {dev} equal the file's bit for bit")


def ft_step_check(cfg, ds, weights, path=("fused", False), ref=("plain", False),
                  against_fp32: bool = False) -> float:
    """Fine-tune step 1 (one batch of `ds`, head dropout on, the same
    augment and dropout streams) from one initial state through `path` and
    through `ref`, each (attn_impl, merged backward). Without
    `against_fp32`: loss, Adam's first moments, updated params and the BN
    running statistics under compare_steps' tolerances. With it (the bf16
    kernels against the bf16 plain twin): the loss and the BN statistics so,
    and `path` at least as close to the step taken in fp32 (the plain path
    with compute_dtype=float32, from the same state) as `ref` is, within
    KERNEL_VS_FP32_RATIO: Adam's first moments in relative L2 (all trainable
    leaves, and the blocks the backward kernels compute) and the share of
    elements that moved against the fp32 step. Returns the share of equal
    bits of `path`'s and `ref`'s updated states."""
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    quiet = MetricLogger(echo=False)
    idx = np.arange(cfg.batch_size)[None]
    out = []
    runs = [(cfg, *path), (cfg, *ref)]
    if against_fp32:
        runs.append((replace_cfg(cfg, compute_dtype="float32"), "plain", False))
    for rcfg, impl, merged in runs:
        os.environ["VIT2SPN_MERGED_BWD"] = "1" if merged else "0"
        tr = FineTuneTrainer(rcfg, ds.num_classes, logger=quiet, attn_impl=impl,
                             device="cuda")
        before = {k: v.copy() for k, v in ckpt._flatten(tr.state).items()}
        loss = float(tr.train_epoch(ds, idx, weights, epoch=0))
        out.append((loss, before, ckpt._flatten(tr.state)))
        del tr
        torch.cuda.empty_cache()
    os.environ["VIT2SPN_MERGED_BWD"] = "0"
    names = [path_name(*p, cfg) for p in (path, ref)]
    if not against_fp32:
        compare_steps("ft-step1", names, out, cfg.learning_rate, ("backbone/", "head/"),
                      ("bn_state/",), skip=FT_ZERO_GRAD)
    else:
        (lf, before, af), (lp, before_p, ap), (l32, before32, a32) = out
        assert all(np.array_equal(before[k], before_p[k]) for k in before)
        assert all(np.array_equal(before[k], before32[k]) for k in before)
        if not (np.isfinite(lf) and abs(lf - lp) <= STEP_LOSS_REL_TOL * abs(lp)):
            raise AssertionError(f"step 1 loss: {names[0]} {lf} vs {names[1]} {lp}")
        mu = [k for k in af if k.startswith("opt_state/") and "/mu/" in k
              and not k.endswith(FT_ZERO_GRAD)]
        blocks = [k for k in mu if "/blocks/" in k]
        dist = {n: (rel_l2(st, a32, mu), rel_l2(st, a32, blocks)) for n, st in zip(names, (af, ap))}
        blocks_l2 = rel_l2(af, ap, blocks)
        stats = [k for k in af if k.startswith("bn_state/") and af[k].dtype.kind == "f"]
        moved = {k: af[k] - before[k] for k in stats}
        s_l2 = rel_l2(moved, {k: ap[k] - before[k] for k in stats}, stats)
        against, total = {}, 0
        for n, st in zip(names, (af, ap)):
            against[n] = 0
            for k in st:
                if k.startswith(("backbone/", "head/")):
                    d, d32 = st[k] - before[k], a32[k] - before[k]
                    if np.abs(d).max() > cfg.learning_rate * (1 + 1e-3) + 1e-7:
                        raise AssertionError(f"{k}: a step larger than the learning rate")
                    against[n] += int(np.sum(np.sign(d) != np.sign(d32)))
                    total += d.size if n == names[0] else 0
        log(f"[ft-step1-{names[0]}-vs-{names[1]}] loss {lf:.6f} vs {lp:.6f} (fp32 step "
            f"{l32:.6f}); Adam first moments' relative L2 from the fp32 step, all leaves / the "
            f"blocks: {names[0]} {dist[names[0]][0]:.4f} / {dist[names[0]][1]:.4f}, {names[1]} "
            f"{dist[names[1]][0]:.4f} / {dist[names[1]][1]:.4f}, {names[0]} vs {names[1]} "
            f"{rel_l2(af, ap, mu):.4f} / {blocks_l2:.4f} (tol on the blocks "
            f"{FT_BLOCKS_MU_L2_TOL}); params moved against the fp32 step in "
            f"{100.0 * against[names[0]] / total:.3f}% / {100.0 * against[names[1]] / total:.3f}%"
            f" of {total} elements; BN statistics' move, relative L2 {s_l2:.3g} (tol "
            f"{STEP_MU_L2_REL_TOL}); ratio tol {KERNEL_VS_FP32_RATIO}")
        if not all(a <= KERNEL_VS_FP32_RATIO * b
                   for a, b in zip(dist[names[0]], dist[names[1]])):
            raise AssertionError(f"step 1 gradients of {names[0]} are further from the fp32 "
                                 f"step than {names[1]}'s")
        if not blocks_l2 <= FT_BLOCKS_MU_L2_TOL:
            raise AssertionError(f"step 1 gradients of the blocks: {names[0]} and {names[1]} "
                                 f"are {blocks_l2:.4f} apart")
        if not against[names[0]] <= KERNEL_VS_FP32_RATIO * against[names[1]] + 1e-4 * total:
            raise AssertionError(f"step 1 of {names[0]} moves against the fp32 step more "
                                 f"often than {names[1]}")
        if not s_l2 <= STEP_MU_L2_REL_TOL:
            raise AssertionError(f"step 1 BN statistics of {names[0]} disagree with {names[1]}")
    af, ap = out[0][2], out[1][2]
    floats = [k for k in af if af[k].dtype.kind == "f"]
    equal = sum(int(np.sum(af[k] == ap[k])) for k in floats) / sum(af[k].size for k in floats)
    log(f"[ft-step1] {names[0]} vs {names[1]}: {100.0 * equal:.4f}% of the updated "
        "state's elements bit-equal")
    return equal


def ft_data():
    """The fine-tune phases' preset, FT_EVAL_IMAGES seeded synthetic images
    and their balanced class weights."""
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.train.optim import balanced_class_weights

    ds = synthetic_dataset(split_sizes={"train": FT_EVAL_IMAGES}, image_size=28,
                           seed=SEED + 3).split("train")
    return get_preset("ft-octmnist"), ds, balanced_class_weights(ds.labels, ds.num_classes)


def ft_step_wall(tf, ds, w) -> float:
    """Wall seconds per warm fine-tune step of trainer `tf`: FT_STEPS steps
    after two warm-up steps, the card synced around them."""
    bs = tf.cfg.batch_size
    idx = np.arange(FT_STEPS * bs).reshape(FT_STEPS, bs) % len(ds)
    tf.train_epoch(ds, idx[:2], w, epoch=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tf.train_epoch(ds, idx, w, epoch=2)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / FT_STEPS


def ft_step_wall_fresh() -> float:
    """ft_step_wall of a new "fused" FineTuneTrainer, run right after the
    build so that no earlier phase has left state in the process."""
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    cfg, ds, w = ft_data()
    tf = FineTuneTrainer(cfg, ds.num_classes, logger=MetricLogger(echo=False), device="cuda")
    step_s = ft_step_wall(tf, ds, w)
    del tf
    torch.cuda.empty_cache()
    return step_s


def finetune_path(ssp_trainer, card, fresh_s) -> dict:
    """The fine-tune path end to end at full width and depth (the
    `ft-octmnist` preset: ViT-Tiny/16, 224 px, 12 layers, B=128, bf16, 4
    classes): (a) step 1 of FineTuneTrainer through "fused" against "plain"
    in bf16 and fp32, and the split backward against the merged one; (b)
    `evaluate` of FT_EVAL_IMAGES images through "fused" against "plain" from
    one state, and its img/s; (d) a warm step's wall time and its device
    time by wrapper, the card's idle share; (c) `run ft-octmnist` through
    the CLI from the export of `ssp_trainer`, cut to FT_FOLDS folds and
    FT_EPOCHS epochs, with the launch counters read around it. `fresh_s` is
    ft_step_wall_fresh's reading, printed beside this phase's. Returns the
    run's launches by kernel."""
    import tempfile

    from vit2spn_tpu_torch.cli import main as cli_main
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    cfg, ds, w = ft_data()
    bs, layers = cfg.batch_size, cfg.vit.num_layers

    # (a) step 1 against a reference path from one state
    ft_step_check(cfg, ds, w, against_fp32=True)
    ft_step_check(replace_cfg(cfg, compute_dtype="float32"), ds, w)
    equal = ft_step_check(cfg, ds, w, ("fused", True), ("fused", False))
    if equal != 1.0:
        raise AssertionError(f"fine-tune step 1: the merged backward's state differs from the "
                             f"split pair's ({100.0 * equal:.4f}% of the elements bit-equal)")

    # (b) evaluate: "fused" against "plain" from one state (one step taken,
    # so the BN running statistics are off their init)
    quiet = MetricLogger(echo=False)
    tf = FineTuneTrainer(cfg, ds.num_classes, logger=quiet, device="cuda")
    tf.train_epoch(ds, np.arange(bs)[None], w, epoch=0)
    tp = FineTuneTrainer(cfg, ds.num_classes, logger=quiet, attn_impl="plain", device="cuda")
    tp.state = tf.state
    tf.evaluate(ds, w)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    loss_f, probs_f, labels = tf.evaluate(ds, w)
    eval_s = time.perf_counter() - t0
    eval_launches = {k: n for k, n in read_launches().items() if n}
    loss_p, probs_p, _ = tp.evaluate(ds, w)
    del tp
    err = float(np.abs(probs_f - probs_p).max())
    agree = float(np.mean(probs_f.argmax(1) == probs_p.argmax(1)))
    n_eval = -(-len(ds) // bs)
    log(f"[ft-eval] evaluate of {len(ds)} images (eval augmentation on, one stream): fused vs "
        f"plain probabilities max_abs_err {err:.4g} (tol {FT_PROB_TOL}), equal argmax "
        f"{100.0 * agree:.2f}%, loss {loss_f:.6f} vs {loss_p:.6f}; launches {eval_launches}; "
        f"{1e3 * eval_s:.2f} ms, {len(ds) / eval_s:.1f} img/s on {card}")
    if probs_f.shape != (len(ds), ds.num_classes) or not np.isfinite(probs_f).all():
        raise AssertionError(f"bad eval probabilities: shape {probs_f.shape}")
    if eval_launches != {KERNEL_NAME: n_eval}:
        raise AssertionError(f"evaluate launched {eval_launches}, expected {n_eval} "
                             f"{KERNEL_NAME} (its no-residual route) and nothing else")
    if not (err <= FT_PROB_TOL and abs(loss_f - loss_p) <= FT_PROB_TOL * max(1.0, abs(loss_p))):
        raise AssertionError("fine-tune evaluate through fused disagrees with plain")

    # (d) a warm step: wall time over FT_STEPS steps (and again with the
    # earlier phases' Python objects frozen out of the garbage collector's
    # scans), device time by wrapper
    step_s = ft_step_wall(tf, ds, w)
    gc.collect()
    gc.freeze()
    frozen_s = ft_step_wall(tf, ds, w)
    gc.unfreeze()
    totals = {}
    lines = stage_breakdown(lambda: tf.train_epoch(ds, np.arange(bs)[None], w, epoch=3),
                            f"one fine-tune step (B={bs}, bf16)",
                            wrappers=(KERNEL_NAME, "mlp_bwd", "attn_bwd"),
                            rest="views, embed, head, loss, Adam", totals=totals)
    for line in lines:
        log(line)
    def idle(wall_s):
        return (f"{100.0 * (1.0 - totals['device'] / (1e3 * wall_s)):.1f}%" if totals
                else "not measured")

    log(f"[time] fine-tune step (B={bs}, bf16): wall {1e3 * step_s:.3f} ms over {FT_STEPS} "
        f"warm steps, {bs / step_s:.1f} img/s; device "
        f"{totals.get('device', float('nan')):.3f} ms; card idle {idle(step_s)} on {card}")
    log(f"[time] fine-tune step wall, same steps: right after the build, before the other "
        f"phases {1e3 * fresh_s:.3f} ms ({bs / fresh_s:.1f} img/s, card idle {idle(fresh_s)}); "
        f"here with the garbage collector's objects frozen {1e3 * frozen_s:.3f} ms "
        f"({bs / frozen_s:.1f} img/s, card idle {idle(frozen_s)}); {len(gc.get_objects())} "
        f"objects tracked here")
    state_bytes = 3 * 4 * sum(t.numel() for t in tf._trainable)  # params, 2 moments
    del tf
    torch.cuda.empty_cache()

    # (c) the CLI end to end from an SSP export
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        export = ssp_trainer.export_backbone(os.path.join(tmp, "ssp_export.npz"))
        out = os.path.join(tmp, "ft")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["run", "ft-octmnist", "--epochs", str(FT_EPOCHS), "--output-dir", out,
                       "-o", f"k_folds={FT_FOLDS}", "-o", f"init_path={export}"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        missing = [a for a in ("roc_curve_all_folds.png", "confusion_matrix.png",
                               "classification_report.txt", "cv_result.json")
                   if not os.path.getsize(os.path.join(out, f"octmnist_{a}"))]
    if rc != 0 or missing:
        raise AssertionError(f"run ft-octmnist: rc {rc}, empty artifacts {missing}")
    by = {}
    for e in events:
        by.setdefault(e["event"], []).append(e)
    sizes = by["protocol"][0]
    n_cv, n_test = sizes["cv_size"], sizes["test_size"]
    # the stratified deal is one round robin over the subset: fold f holds
    # positions f, f + k, ...
    steps = evals = 0
    for f in range(FT_FOLDS):
        n_val = len(range(f, n_cv, FT_FOLDS))
        epochs = len(by.get(f"fold{f}_epoch", []))
        steps += epochs * max((n_cv - n_val) // bs, 1)
        evals += (epochs + 1) * -(-n_val // bs)  # per epoch, then the fold's ROC
    evals += -(-n_test // bs)  # the best fold's model on the test set
    want = {KERNEL_NAME: steps + evals, "mlp_bwd": layers * steps, "attn_bwd": layers * steps}
    aucs = [e["mauc"] for e in by.get("fold_result", [])]
    mem = by.get("fold_memory", [])
    peaks = [e["peak_allocated_bytes"] for e in mem]
    held = [e["allocated_bytes"] for e in mem]
    warm = [e["images_per_sec"] for k, v in by.items() if k.endswith("_epoch")
            for e in v if e["epoch"] == FT_EPOCHS]
    summary = by.get("cv_summary", [{}])[0]
    log(f"[finetune] run ft-octmnist (cut: {FT_FOLDS} folds, {FT_EPOCHS} epochs; subset "
        f"{n_cv}, test {n_test}, width and depth the preset's) from the SSP export in "
        f"{run_s:.1f} s: {steps} train steps, {evals} eval batches; launches "
        f"{ {k: n for k, n in launches.items() if n} } (expected {want}); fold mAUCs {aucs}; "
        f"test accuracy {summary.get('test_accuracy')}; per-fold peak / held MiB "
        f"{[round(p / 2**20, 1) for p in peaks]} / {[round(h / 2**20, 1) for h in held]}; "
        f"warm-epoch train img/s {[round(x, 1) for x in warm]} on {card}")
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"run ft-octmnist launched {launches}, expected {want}")
    if len(aucs) != FT_FOLDS or not all(np.isfinite(aucs)) or "cv_summary" not in by:
        raise AssertionError(f"run ft-octmnist: fold mAUCs {aucs}, events {sorted(by)}")
    # fold 0 holds one model; from fold 1 on, the best so far may be kept
    # beside the current one: memory may sit one model's state (params and
    # two Adam moments, plus 8 MiB of staged folds) above fold 0's, never more
    slack = 1.1 * state_bytes + 8 * 2**20
    if len(peaks) != FT_FOLDS or any(p > peaks[0] + slack for p in peaks) \
            or any(h > held[0] + slack for h in held):
        raise AssertionError(f"per-fold device memory grows: peaks {peaks}, held {held} "
                             f"(one model's state {state_bytes} bytes)")
    return {k: n for k, n in launches.items() if n}


# Phase 12: the folder datasets and the parity runbook, on inputs staged here
FOLDER_SPLITS = {"train": 16384, "val": 2048, "test": 2048}  # the staged octmnist.npz
OCTID_FILES = 572  # over 5 classes, as the OCTID loader's synthetic stand-in
OCTID_HW = (288, 384)  # (H, W) of the staged OCTID files: not square
UCSD_FILES = {"train": 480, "test": 32}  # per class: 2,048 merged over 4 classes
UCSD_HW = (300, 320)
FOLDER_FOLDS = 3  # `run ft-ucsdoct` cut from 10 folds
FOLDER_STEP_IMAGES = 512  # the 256 px fine-tune step's dataset
# The augmentation at 256 px sources on the card against the same function on
# the CPU from the same parameters: fp32 differs by the order of sums of the
# band limit's and the resize's products and the warp's bilinear weights
# (max 1e-4 absolute on normalized pixels, mean 1e-6); in bf16 a sum that
# lands near a rounding boundary of the band-limited source moves one bf16
# step, which the warp carries: at most 4 steps at |x| < 4 (0.0625), mean 1e-3.
AUG_TOL = {"float32": (1e-4, 1e-6), "bfloat16": (0.0625, 1e-3)}


def _smooth_image(rng, hw, cls) -> np.ndarray:
    """A smooth grayscale image whose stripe frequency codes the class (it
    compresses to a small JPEG)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    theta, phase = rng.uniform(0, np.pi), rng.uniform(0, 2 * np.pi)
    wave = np.sin(2 * np.pi * 2.0 * (1.8 ** cls) * (xx * np.cos(theta) + yy * np.sin(theta))
                  + phase)
    return (255 * (0.5 + 0.4 * wave)).astype(np.uint8)


def stage_folder_inputs(root: str) -> None:
    """Writes under `root`: octmnist.npz (medmnist keys, 28 px, 4 classes,
    FOLDER_SPLITS; the multitrial preset's subset, the protocol's first draw
    at the preset's seed, holds each class a quarter of the time, so each of
    its 10 folds holds every class); octird/<class>/ with OCTID_FILES
    non-square JPEGs over 5 classes; ucsdoct/{train,test}/<class>/ with
    UCSD_FILES JPEGs per class, for `data merge-ucsd`."""
    from PIL import Image

    from vit2spn_tpu_torch.core.presets import get_preset

    rng = np.random.default_rng(SEED + 12)
    arrs = {}
    for split, n in FOLDER_SPLITS.items():
        labels = rng.permutation(np.arange(n) % 4)
        if split == "train":
            mt = get_preset("multitrial/ft-octmnist")
            sub = np.random.default_rng(mt.seed).choice(
                n, int(n * mt.data.subset_fraction), replace=False)
            labels[sub] = np.arange(len(sub)) % 4
        noise = rng.integers(0, 96, (n, 28, 28), dtype=np.uint8)
        arrs[f"{split}_images"] = noise + (40 * labels).astype(np.uint8)[:, None, None]
        arrs[f"{split}_labels"] = labels.reshape(-1, 1)
    os.makedirs(root, exist_ok=True)
    np.savez(os.path.join(root, "octmnist.npz"), **arrs)
    for i in range(OCTID_FILES):
        cls = i % 5
        d = os.path.join(root, "octird", ("amd", "csr", "dr", "mh", "normal")[cls])
        os.makedirs(d, exist_ok=True)
        Image.fromarray(_smooth_image(rng, OCTID_HW, cls), "L").save(
            os.path.join(d, f"{i:04d}.jpg"))
    for split, n in UCSD_FILES.items():
        for cls, name in enumerate(("CNV", "DME", "DRUSEN", "NORMAL")):
            d = os.path.join(root, "ucsdoct", split, name)
            os.makedirs(d, exist_ok=True)
            for i in range(n):
                Image.fromarray(_smooth_image(rng, UCSD_HW, cls), "L").save(
                    os.path.join(d, f"{name}-{split}-{i:04d}.jpeg"))


def protocol_launches(cfg, ds, epochs: int, per_fold_test: bool = False) -> tuple:
    """Predicted (train steps, eval batches, cv size, test size) of one
    run_cv_protocol of `cfg` over `ds`: the protocol's own subsets and folds;
    per fold `epochs` epochs of max(n_train // B, 1) steps, an evaluation of
    the val fold after each epoch and one more for its ROC (with
    `per_fold_test`, one of the test set too); then the best fold's model on
    the test set. No early stop can end an epoch count this short."""
    from vit2spn_tpu_torch.evals.kfold import stratified_kfold
    from vit2spn_tpu_torch.evals.protocol import select_subsets

    cv, test = select_subsets(cfg, ds)
    bs = cfg.batch_size
    n_test = -(-len(test) // bs)
    steps = evals = 0
    for tr, va in stratified_kfold(cv.labels, cfg.k_folds, seed=cfg.seed):
        steps += epochs * max(len(tr) // bs, 1)
        evals += (epochs + 1) * -(-len(va) // bs) + (n_test if per_fold_test else 0)
    return steps, evals + n_test, len(cv), len(test)


def _wanted(steps: int, evals: int, layers: int, backbone_calls: int = 0, bwd_calls: int = 0):
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME

    return {KERNEL_NAME: backbone_calls + steps + evals, "mlp_bwd": bwd_calls + layers * steps,
            "attn_bwd": bwd_calls + layers * steps}


def check_launches(what: str, launches: dict, want: dict) -> None:
    ran = {k: n for k, n in launches.items() if n}
    log(f"[folder] {what}: launches {ran} (predicted {want})")
    if launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"{what} launched {ran}, predicted {want} and no other wrapper")


def check_folder_augment(dev) -> None:
    """The folder presets' augmentation at 256 px sources (square, UCSD's
    0.5/0.5 normalization; and a non-square (H, W) decode) on the card
    against the same function on the CPU, from the same parameters drawn on
    the CPU: the band limit's pre-shrink and squash, the warp, jitter, blur,
    erasing and both output forms, in fp32 and bf16 (AUG_TOL)."""
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data import augment as aug

    rng = np.random.default_rng(SEED + 13)
    for preset, hw in (("ft-ucsdoct", (256, 256)), ("ft-octid", (248, 256))):
        cfg = get_preset(preset).data.augment
        u8 = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH,) + hw + (1,), dtype=np.uint8))
        p = aug.sample_params(torch.Generator().manual_seed(SEED), TRAIN_BATCH, cfg,
                              (cfg.out_size, cfg.out_size))
        for dtype in (torch.float32, torch.bfloat16):
            for fold in (True, False):
                outs = []
                for d in ("cpu", dev):
                    gray = aug._band_limit(aug._to_gray(u8.to(d)).to(dtype), cfg.band_limit)
                    pd = aug.AugParams(*(t.to(d) for t in p))
                    outs.append(aug._normalize(aug.apply_params(gray, pd, cfg), cfg, dtype,
                                               fold).float().cpu())
                err = (outs[1] - outs[0]).abs()
                tol_max, tol_mean = AUG_TOL[str(dtype).split(".")[1]]
                log(f"[folder-aug] {preset} {hw[0]}x{hw[1]} -> {cfg.out_size} px, {dtype}, "
                    f"{'pre-normalize' if fold else 'normalized'} (mean {cfg.normalize_mean[0]}): "
                    f"card vs CPU max_abs_err {float(err.max()):.4g} (tol {tol_max}), mean "
                    f"{float(err.mean()):.4g} (tol {tol_mean})")
                if not (float(err.max()) <= tol_max and float(err.mean()) <= tol_mean):
                    raise AssertionError(f"the augmentation at {hw} px disagrees with the CPU")


def folder_path(ssp_trainer, card) -> dict:
    """Phase 12: the folder datasets and the parity runbook at the full
    ViT-Tiny width and depth, bf16, on the card, from inputs staged in a
    temporary directory (stage_folder_inputs; the seeded HF-layout weight
    file through VIT2SPN_VIT_TINY_PATH). Returns the launches of (c) and (d)
    by kernel."""
    import contextlib
    import io
    import tempfile

    from vit2spn_tpu_torch.cli import main as cli_main
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.evals.parity import compute_status, run_parity
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.train.optim import balanced_class_weights
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    t_phase = time.perf_counter()
    quiet = MetricLogger(echo=False)
    vit = ssp_trainer.cfg.vit
    layers = vit.num_layers
    total = {}
    old_weights = os.environ.get("VIT2SPN_VIT_TINY_PATH")
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        root = os.path.join(tmp, "datasets")
        t0 = time.perf_counter()
        stage_folder_inputs(root)
        weights = os.path.join(tmp, "vit_tiny.npz")
        np.savez(weights, **pretrained_state(vit))
        os.environ["VIT2SPN_VIT_TINY_PATH"] = weights
        with contextlib.redirect_stdout(io.StringIO()) as merged:
            rc = cli_main(["data", "merge-ucsd", os.path.join(root, "ucsdoct")])
        stats = json.loads(merged.getvalue())
        log(f"[folder] staged octmnist.npz {FOLDER_SPLITS}, {OCTID_FILES} OCTID files "
            f"{OCTID_HW[1]}x{OCTID_HW[0]}, UCSD train/test {UCSD_FILES} per class merged by "
            f"`data merge-ucsd` (rc {rc}) into {stats} in {time.perf_counter() - t0:.2f} s (host)")
        if rc != 0 or sum(stats.values()) != 4 * sum(UCSD_FILES.values()):
            raise AssertionError(f"data merge-ucsd: rc {rc}, {stats}")
        # (a) `data stats octid`, and the folder decodes' host seconds alone
        out_a = os.path.join(tmp, "stats")
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["data", "stats", "octid", "--root", root, "--out", out_a])
        with open(os.path.join(out_a, "octid_dataset_summary.json")) as f:
            summary = json.load(f)
        log(f"[folder] data stats octid: rc {rc}, {summary['num_samples']} images, classes "
            f"{summary['class_distribution']}, raw {summary['image_properties']['avg_width']:.0f}"
            f"x{summary['image_properties']['avg_height']:.0f}, decoded "
            f"{summary['image_size']}")
        if rc != 0 or summary["num_samples"] != OCTID_FILES or not all(
                os.path.getsize(os.path.join(out_a, f"octid_{n}.png"))
                for n in ("samples", "distribution")):
            raise AssertionError(f"data stats octid: rc {rc}, {summary}")
        loaded, decode = {}, {}
        for name in ("octid", "ucsdoct"):
            t0 = time.perf_counter()
            loaded[name] = load_dataset(name, root=root, allow_synthetic=False)
            decode[name] = time.perf_counter() - t0
        log("[time] folder decode on the host (PIL, grayscale, bilinear to 256 px): "
            + ", ".join(f"{k} {len(loaded[k])} files in {sec:.3f} s "
                        f"({len(loaded[k]) / sec:.0f} files/s)" for k, sec in decode.items()))
        octid, ucsd = loaded["octid"], loaded["ucsdoct"]
        if ucsd.class_names != ["CNV", "DME", "DRUSEN", "NORMAL"]:
            raise AssertionError(f"the merged UCSD folder loads as {ucsd.class_names}")

        # (b) the augmentation at 256 px sources, card vs CPU
        check_folder_augment(torch.device("cuda", 0))

        # a warm B=128 ft-ucsdoct step: device time by wrapper and its wall
        cfg_u = get_preset("ft-ucsdoct")
        sds = ucsd.subset(np.arange(FOLDER_STEP_IMAGES))
        w = balanced_class_weights(sds.labels, sds.num_classes)
        tf = FineTuneTrainer(cfg_u, sds.num_classes, logger=quiet, device="cuda")
        step_s = ft_step_wall(tf, sds, w)
        totals = {}
        bs = cfg_u.batch_size
        for line in stage_breakdown(lambda: tf.train_epoch(sds, np.arange(bs)[None], w, epoch=3),
                                    f"one ft-ucsdoct step (B={bs}, bf16, 256 px sources)",
                                    wrappers=(KERNEL_NAME, "mlp_bwd", "attn_bwd"),
                                    rest="views at 256 px, embed, head, loss, Adam",
                                    totals=totals):
            log(line)
        idle = (f"{100.0 * (1.0 - totals['device'] / (1e3 * step_s)):.1f}%" if totals
                else "not measured")
        log(f"[time] ft-ucsdoct step (B={bs}, bf16, 256 px sources): wall {1e3 * step_s:.3f} "
            f"ms over {FT_STEPS} warm steps, {bs / step_s:.1f} img/s; device "
            f"{totals.get('device', float('nan')):.3f} ms; card idle {idle} on {card} "
            f"(the 28 px ft-octmnist step of phase 10b beside it)")
        del tf
        torch.cuda.empty_cache()

        # (c) `run ft-ucsdoct` through the CLI, cut to FOLDER_FOLDS folds, 1 epoch
        export = ssp_trainer.export_backbone(os.path.join(tmp, "ssp_export.npz"))
        cfg_c = replace_cfg(cfg_u, k_folds=FOLDER_FOLDS)
        steps, evals, n_cv, n_test = protocol_launches(cfg_c, ucsd, 1)
        want_c = _wanted(steps, evals, layers)
        out_c = os.path.join(tmp, "ft_ucsdoct")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["run", "ft-ucsdoct", "--epochs", "1", "--output-dir", out_c,
                           "-o", f"k_folds={FOLDER_FOLDS}", "-o", f"data.root={root}",
                           "-o", f"init_path={export}"])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches_c = read_launches()
        with open(os.path.join(out_c, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        sizes = next(e for e in events if e["event"] == "protocol")
        aucs = [e["mauc"] for e in events if e["event"] == "fold_result"]
        mem = [round(e["peak_allocated_bytes"] / 2**20, 1) for e in events
               if e["event"] == "fold_memory"]
        log(f"[folder] run ft-ucsdoct (cut: {FOLDER_FOLDS} folds, 1 epoch; subset {n_cv}, "
            f"test {n_test} predicted, {sizes['cv_size']} / {sizes['test_size']} run) in "
            f"{run_s:.1f} s: {steps} train steps, {evals} eval batches; fold mAUCs {aucs}; "
            f"per-fold peak MiB {mem} on {card}")
        if rc != 0 or (sizes["cv_size"], sizes["test_size"]) != (n_cv, n_test) \
                or len(aucs) != FOLDER_FOLDS or not all(np.isfinite(aucs)):
            raise AssertionError(f"run ft-ucsdoct: rc {rc}, sizes {sizes}, aucs {aucs}")
        check_launches("run ft-ucsdoct", launches_c, want_c)

        # (d) the parity runbook on the staged root, multitrial included
        octm = load_dataset("octmnist", root=root, allow_synthetic=False)
        ssp_steps = len(octm.split("train")) // ssp_trainer.cfg.effective_batch
        a = ssp_trainer.cfg.accumulation_steps
        probe = 2 * -(-min(256, len(octm.split("train"))) // 128)  # 2 streams per batch
        parts = [protocol_launches(get_preset(n), d, 1) for n, d in (
            ("ft-octmnist", octm), ("ft-octid", octid), ("ft-ucsdoct", ucsd))]
        mt = get_preset("multitrial/ft-octmnist")
        parts += [protocol_launches(mt, octm, 1, per_fold_test=True)] * mt.num_trials
        want_d = _wanted(sum(p[0] for p in parts), sum(p[1] for p in parts), layers,
                         backbone_calls=ssp_steps * 2 * 2 * a + probe,
                         bwd_calls=ssp_steps * 2 * a * layers)
        out_d = os.path.join(tmp, "parity")
        os.makedirs(out_d)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        report = run_parity(data_root=root, out_dir=out_d, epochs=1, ft_epochs=1,
                            logger=MetricLogger(os.path.join(out_d, "parity_metrics.jsonl"),
                                                echo=False))
        torch.cuda.synchronize()
        parity_s = time.perf_counter() - t0
        launches_d = read_launches()
        with open(os.path.join(out_d, "parity_report.json")) as f:
            written = json.load(f)
        log(f"[parity] run_parity(epochs=1, ft_epochs=1) on the staged root in {parity_s:.1f} s: "
            f"status {report['status']!r}; inputs {report['inputs']}; ssp "
            f"{ {k: v for k, v in report['ssp'].items() if k != 'export'} }; "
            + "; ".join(f"{k} mAUC {e['measured_mauc']:.4f} acc {e['measured_accuracy']:.4f}"
                        for k, e in report["datasets"].items())
            + f"; multitrial {report.get('multitrial')}; {ssp_steps} SSP steps, fine-tune "
            f"protocols (steps, evals, cv, test) {parts[:4]} and {mt.num_trials - 1} more trials")
        if report["status"] != compute_status(written) or written["status"] != report["status"]:
            raise AssertionError(f"parity status {report['status']!r} is not compute_status "
                                 f"of its report ({compute_status(written)!r})")
        if report["ssp"]["init_provenance"] != "pretrained" or not all(report["inputs"].values()) \
                or set(report["datasets"]) != {"octmnist", "octid", "ucsdoct"} \
                or "multitrial" not in report or report["ssp"]["epochs_run"] != 1:
            raise AssertionError(f"parity report incomplete: {written}")
        check_launches("run_parity", launches_d, want_d)
        total = {k: launches_c[k] + launches_d[k] for k in launches_c}

        # (e) convert (d)'s export to .pth and back, inspect, plot (c)'s result
        src = report["ssp"]["export"]
        pth, back = os.path.join(tmp, "export.pth"), os.path.join(tmp, "export_back.npz")
        with contextlib.redirect_stdout(io.StringIO()) as text, \
                contextlib.redirect_stderr(io.StringIO()):
            rcs = [cli_main(["convert", src, pth]), cli_main(["convert", pth, back]),
                   cli_main(["inspect", pth]),
                   cli_main(["plot", "roc", "--result",
                             os.path.join(out_c, "ucsdoct_cv_result.json"),
                             "--out", os.path.join(tmp, "roc.png")]),
                   cli_main(["plot", "cm", "--result",
                             os.path.join(out_c, "ucsdoct_cv_result.json"),
                             "--out", os.path.join(tmp, "cm.png")])]
        with np.load(src) as a_, np.load(back) as b_:
            keys = [k for k in a_.files if k != "__metadata__"]
            equal = sorted(keys) == sorted(k for k in b_.files if k != "__metadata__") and all(
                np.array_equal(a_[k], b_[k]) for k in keys)
        rows = [line for line in text.getvalue().splitlines() if "  (" in line]
        n_hf = len(torch.load(pth, weights_only=True))
        log(f"[folder] convert export -> .pth -> .npz: {len(keys)} leaves equal {equal}; "
            f"inspect .pth: {len(rows)} arrays of {n_hf}; plot roc / cm: rcs {rcs}")
        if rcs != [0] * 5 or not equal or len(rows) != n_hf or not all(
                os.path.getsize(os.path.join(tmp, n)) for n in ("roc.png", "cm.png")):
            raise AssertionError(f"convert / inspect / plot: rcs {rcs}, leaves equal {equal}")
    if old_weights is None:
        del os.environ["VIT2SPN_VIT_TINY_PATH"]
    else:
        os.environ["VIT2SPN_VIT_TINY_PATH"] = old_weights
    log(f"[folder] phase 12 in {time.perf_counter() - t_phase:.1f} s")
    return {k: n for k, n in total.items() if n}


# Phase 13: several ranks (parallel/) on the one card. NCCL will not put two
# ranks on one device, so the card holds world size 1 over NCCL (torchrun)
# and two gloo ranks sharing cuda:0 (gloo takes CUDA tensors).
#   (a) `run ssp` under torchrun equals the plain `run ssp` bit for bit (the
#       world-1 all-reduce is the identity and the kernels give equal bits),
#       with the same wrapper calls, PARALLEL_MICRO of each per microbatch;
#       the two runs side by side on the card;
#   (b) 2 gloo ranks against world size 1 from one state, augmentation off
#       and dropout 0, at fp32 and bf16: the SSP step with an uneven masked
#       tail and a one-step fine-tune epoch with global BN, both within the
#       step-1 tolerances of every path comparison here (compare_steps: the
#       two differ only in the order of the ranks' sums, far inside them;
#       the bf16 fine-tune step in relative L2 only, as phase 10b holds its
#       bf16 step, since its BN head's gradients cancel), evaluate's
#       probabilities within FT_PROB_TOL, and each rank's kernel launches
#       equal world size 1's;
#   (c) the dry run's three stages on (b)'s two ranks, in the same spawn
#       (entry.py::_dryrun_rank, which dryrun_multichip(2) spawns ranks to
#       run): three OK lines, 27 sharded leaves.
PARALLEL_MICRO = {"backbone_fwd": 4, "mlp_bwd": 24, "attn_bwd": 24}  # dual stream
PARALLEL_TRAIN = 800  # `run ssp` of (a): 3 steps of 2 x 128 and a masked tail of 32
PARALLEL_TIMEOUT = 600


def timed_ssp_step(cfg, reps: int = 3) -> dict:
    """On this process's rank (any world size): an SSPTrainer step over a
    staged synthetic batch, warm, its wall time over `reps` steps, one
    step's device time by kernel, and (under a process group) the time of
    its one all-reduce alone: all_reduce_grads on the step's gradients, CUDA
    events over 10 calls."""
    from vit2spn_tpu_torch.parallel.shard_map_dp import all_reduce_grads
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    tr = SSPTrainer(cfg, logger=MetricLogger(echo=False),
                    device=torch.device("cuda", torch.cuda.current_device()))
    eff = cfg.effective_batch
    tr.attach_dataset(synthetic_dataset(image_size=28, split_sizes={"train": eff},
                                        seed=SEED).images)
    idx = np.arange(eff)
    tr.train_step_indices(idx, (1, 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(reps):
        tr.train_step_indices(idx, (1, 1 + r))
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    totals = {}
    lines = stage_breakdown(
        lambda: tr.train_step_indices(idx, (1, 10)),
        f"one optimizer step, rank {tr.mesh.rank} of {tr.mesh.world_size}",
        wrappers=(KERNEL_NAME, "mlp_bwd", "attn_bwd"), rest="patch embed, heads, loss, "
        "Adam, EMA, the collective's kernels", totals=totals)
    comm = {k: v for k, v in totals.get("kernels", {}).items()
            if "nccl" in k.lower() or "memcpy" in k.lower()}
    grads = [p.grad for p in tr._trainable]
    ar_ms = (time_ms(lambda: all_reduce_grads(grads, tr.mesh), iters=10, warmup=2)
             if tr.mesh.distributed else None)
    return {"rank": tr.mesh.rank, "world": tr.mesh.world_size, "wall_ms": 1e3 * wall,
            "device_ms": totals.get("device"), "comm": comm, "lines": lines,
            "allreduce_ms": ar_ms, "grad_mb": 4 * sum(g.numel() for g in grads) / 2**20}


def run_modules(jobs: dict) -> dict:
    """`python -m <argv>` for each job of `jobs` ({name: (argv, log path,
    under `torchrun --standalone --nproc_per_node=1`)}) from the repository
    root, all started together, each one's output into its log. Returns
    {name: (exit code, seconds from the start to its exit)}; kills every
    one still running at PARALLEL_TIMEOUT."""
    root = os.path.dirname(os.path.abspath(__file__))
    procs, done, t0 = {}, {}, time.perf_counter()
    try:
        for name, (argv, log_path, torchrun) in jobs.items():
            cmd = [sys.executable] + (["-m", "torch.distributed.run", "--standalone",
                                       "--nproc_per_node=1"] if torchrun else []) + argv
            f = open(log_path, "w")
            procs[name] = (subprocess.Popen(cmd, cwd=root, stdout=f, stderr=subprocess.STDOUT),
                           f)
        while len(done) < len(procs):
            if time.perf_counter() - t0 > PARALLEL_TIMEOUT:
                raise TimeoutError(f"{sorted(set(procs) - set(done))} still running after "
                                   f"{PARALLEL_TIMEOUT} s")
            for name, (proc, f) in procs.items():
                if name not in done and proc.poll() is not None:
                    done[name] = (proc.returncode, time.perf_counter() - t0)
                    f.close()
            time.sleep(0.1)
    finally:
        for proc, f in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            f.close()
    for name, (rc, _) in done.items():
        if rc != 0:
            argv, log_path, _ = jobs[name]
            log(f"[parallel] {' '.join(argv[:4])} ({name}) failed (rc {rc}); its output's end:\n"
                + open(log_path).read()[-4000:])
    return done


def profile_counts(out_dir: str) -> dict:
    """The wrapper ranges' calls from a `run --profile` metrics.jsonl."""
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        ops = [json.loads(line) for line in f]
    return {e["source"].split("::")[1]: e["count"] for e in ops
            if e["event"] == "profile_op" and e["source"].startswith("vit2spn::")}


def check_profile_run(out_dir: str, vit, secs: float) -> None:
    """A `run ssp --profile` run's metrics.jsonl in `out_dir` (ViT config
    `vit`): its profile_op lines name the three wrappers' ranges,
    device_memory reads nonzero, model_info's backbone GFLOPs equal the
    products counted here."""
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME

    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        events = [json.loads(line) for line in f]
    ops = [e for e in events if e["event"] == "profile_op"]
    info = next(e for e in events if e["event"] == "model_info")
    mem = next((e for e in events if e["event"] == "device_memory"), {})
    s, d, mlp, layers = vit.seq_len, vit.hidden_size, vit.mlp_dim, vit.num_layers
    backbone = (2 * (s - 1) * vit.patch_size ** 2 * 3 * d
                + layers * (2 * s * d * 3 * d + 2 * 2 * s * s * d + 2 * s * d * d
                            + 2 * 2 * s * d * mlp))
    cost = next(e for e in events if e["event"] == "profile_trace")
    fit = [e for e in events if e["event"] == "ssp_epoch"]
    log(f"[profile] run ssp --profile --epochs 1 in {secs:.1f} s (the epoch "
        f"{fit[0]['seconds']:.1f} s under the profiler; the trace {cost['mib']:.1f} MiB "
        f"gzipped, written in {cost['write_s']:.1f} s and read back in "
        f"{cost['read_s']:.1f} s); profile_op "
        + "; ".join(f"{e['source']} {e['total_us'] / 1e3:.3f} ms x{e['count']}" for e in ops))
    log(f"[profile] model_info { {k: v for k, v in info.items() if k not in ('event', 'time')} }"
        f" (one backbone's products counted here: {backbone / 1e9:.4f} GFLOP); "
        f"device_memory {mem.get('0')}")
    names = {e["source"] for e in ops}
    missing = [f"vit2spn::{k}" for k in (KERNEL_NAME, "mlp_bwd", "attn_bwd")
               if f"vit2spn::{k}" not in names]
    if missing:
        raise AssertionError(f"run ssp --profile: profile_op lacks {missing}")
    if info["backbone_gflops"] != round(backbone / 1e9, 4) \
            or not mem.get("0", {}).get("bytes_in_use_mb", 0) > 0:
        raise AssertionError(f"model_info {info} / device_memory {mem}")


def parallel_path(card: str) -> dict:
    """Phase 13: (a) `run ssp` under torchrun vs plain; (b) 2 gloo ranks on
    cuda:0 vs world size 1 at fp32 and bf16, and their step's wall, device
    and all-reduce time; (c) the dry run's stages on (b)'s ranks (`parity
    --smoke`, which now takes the kernels' general route, runs in phase 17
    (d)). Returns rank 0's launches in (b)'s compared runs by kernel entry
    name (the fp32 runs' under "<name> (fp32)")."""
    import tempfile

    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.entry import _dryrun_rank, finetune_epoch, ssp_step
    from vit2spn_tpu_torch.parallel.launch import call_each, launch
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.finetune import FineTuneTrainer
    from vit2spn_tpu_torch.train.optim import balanced_class_weights
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    t_phase = time.perf_counter()
    quiet = MetricLogger(echo=False)
    with tempfile.TemporaryDirectory(prefix="vit2spn_parallel_") as tmp:
        # (a) `run ssp` cut to 1 epoch of PARALLEL_TRAIN staged images at 2 x 128, one
        # checkpoint, with --profile (the wrappers' calls), plain and under torchrun
        ds = synthetic_dataset(image_size=28, seed=SEED,
                               split_sizes={"train": PARALLEL_TRAIN, "val": 8, "test": 8})
        np.savez(os.path.join(tmp, "octmnist.npz"),
                 **{f"{k}_images": ds.images[ds.splits[k], ..., 0] for k in ds.splits},
                 **{f"{k}_labels": ds.labels[ds.splits[k], None] for k in ds.splits})
        argv = ["-m", "vit2spn_tpu_torch", "run", "ssp", "--epochs", "1", "--profile",
                "-o", f"data.root={tmp}", "-o", "accumulation_steps=2",
                "-o", "checkpoint_every_epochs=1", "-o", "pretrained_init=false"]
        cfg_a = replace_cfg(get_preset("ssp"), accumulation_steps=2, pretrained_init=False)
        eff = cfg_a.effective_batch
        spe, rem = PARALLEL_TRAIN // eff, PARALLEL_TRAIN % eff
        n_micro = spe * cfg_a.accumulation_steps + -(-rem // cfg_a.batch_size)
        want = {k: n * n_micro for k, n in PARALLEL_MICRO.items()}
        # both at once on the card: each run is deterministic, and the checks are
        # their outputs and calls (the wall times are not compared)
        outs = {name: os.path.join(tmp, name) for name in ("plain", "torchrun")}
        done = run_modules({name: (argv + ["--output-dir", out], out + ".log",
                                   name == "torchrun") for name, out in outs.items()})
        runs = {}
        for name, out in outs.items():
            rc, secs = done[name]
            if rc != 0:
                raise AssertionError(f"run ssp ({name}) exited {rc}")
            runs[name] = (out, secs, profile_counts(out))
        same = {}
        for fname in (cfg_a.export_name + ".npz", "checkpoint.npz"):
            with np.load(os.path.join(runs["plain"][0], fname)) as a_, \
                    np.load(os.path.join(runs["torchrun"][0], fname)) as b_:
                keys = [k for k in a_.files if k != "__metadata__"]
                same[fname] = (sorted(keys) == sorted(k for k in b_.files if k != "__metadata__")
                               and all(np.array_equal(a_[k], b_[k]) for k in keys))
        got = {n: {k: c.get(k) for k in want} for n, (_, _, c) in runs.items()}
        log(f"[parallel] (a) run ssp, 1 epoch of {PARALLEL_TRAIN} images at 2 x 128 "
            f"({n_micro} microbatches), both started together: plain {runs['plain'][1]:.1f} s, "
            f"torchrun (world 1, NCCL) {runs['torchrun'][1]:.1f} s; export and checkpoint "
            f"bit-equal "
            f"{same}; wrapper calls plain {got['plain']}, torchrun {got['torchrun']} "
            f"(predicted {want})")
        if not all(same.values()):
            raise AssertionError(f"run ssp under torchrun differs from the plain run: {same}")
        if got["plain"] != want or got["torchrun"] != want:
            raise AssertionError(f"run ssp launches {got}, predicted {want}")
        check_profile_run(runs["plain"][0], cfg_a.vit, runs["plain"][1])
        # (b) 2 gloo ranks on cuda:0 against world size 1, fp32 and bf16
        batch = synthetic_dataset(image_size=28, split_sizes={"train": 256},
                                  seed=SEED + 1).images
        w = np.ones(256, np.float32)
        w[-40:] = 0.0  # microbatch 2: rank 0's slice all real, rank 1's 24 of 64
        ft_ds = synthetic_dataset(image_size=28, split_sizes={"train": 256}, seed=SEED + 2)
        ft_w = balanced_class_weights(ft_ds.labels, ft_ds.num_classes)
        calls, checks, launched_b = [], [], {}
        for dtype in ("float32", "bfloat16"):
            cfg = replace_cfg(get_preset("ssp"), pretrained_init=False, accumulation_steps=2,
                              proj_dropout=0.0, compute_dtype=dtype,
                              **{"data.augment.enabled": False})
            start = os.path.join(tmp, f"ssp_{dtype}.npz")
            tr = SSPTrainer(cfg, logger=quiet, device="cuda")
            ckpt.save(start, tr.state)
            before = ckpt._flatten(tr.state)
            del tr
            calls.append((ssp_step, (cfg, batch, w), {"checkpoint": start, "device": "cuda:0"}))
            checks.append(("ssp", dtype, cfg, before))
            fcfg = replace_cfg(get_preset("ft-octmnist"), head_dropout=0.0, compute_dtype=dtype,
                               **{"data.augment.enabled": False})
            start = os.path.join(tmp, f"ft_{dtype}.npz")
            ft = FineTuneTrainer(fcfg, ft_ds.num_classes, logger=quiet, device="cuda")
            ckpt.save(start, ft.state)
            before = ckpt._flatten(ft.state)
            del ft
            calls.append((finetune_epoch, (fcfg, ft_ds, np.arange(128)[None], ft_w),
                          {"checkpoint": start, "device": "cuda:0"}))
            checks.append(("ft", dtype, fcfg, before))
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        two = launch(call_each, 2, args=(calls + [(timed_ssp_step, (calls[2][1][0],), {}),
                                                  (_dryrun_rank, (2, "cuda:0"), {})],),
                     device="cuda:0", timeout=PARALLEL_TIMEOUT)
        two_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        one = call_each([(fn, a, {**kw, "device": "cuda"}) for fn, a, kw in calls])
        log(f"[parallel] (b) 2 ranks in {two_s:.1f} s, world size 1 in "
            f"{time.perf_counter() - t0:.1f} s")
        for i, (kind, dtype, cfg, before) in enumerate(checks):
            r0, r1, ref = two[0][i], two[1][i], one[i]
            equal = all(np.array_equal(r0["state"][k], r1["state"][k]) for k in r0["state"])
            tag = f"parallel-{kind}-{'fp32' if dtype == 'float32' else 'bf16'}"
            if kind == "ssp":
                compare_steps(tag, ["2 ranks", "1 rank"], [(r0["loss"], before, r0["state"]),
                                                            (ref["loss"], before, ref["state"])],
                              cfg.learning_rate, ("params/online/", "params/heads/"))
            else:
                compare_steps(tag, ["2 ranks", "1 rank"], [(r0["loss"], before, r0["state"]),
                                                            (ref["loss"], before, ref["state"])],
                              cfg.learning_rate, ("backbone/", "head/"), ("bn_state/",),
                              skip=FT_ZERO_GRAD,
                              mu_max_tol=STEP_MU_MAX_REL_TOL if dtype == "float32" else None)
                perr = float(np.abs(r0["probs"] - ref["probs"]).max())
                log(f"[{tag}] evaluate: probabilities max |2 ranks - 1 rank| {perr:.3g} "
                    f"(tol {FT_PROB_TOL}), loss {r0['val_loss']:.6f} vs {ref['val_loss']:.6f}")
                if not (perr <= FT_PROB_TOL and np.array_equal(r0["probs"], r1["probs"])):
                    raise AssertionError(f"{tag}: evaluate disagrees with world size 1")
            log(f"[{tag}] rank 0 / rank 1 / world 1 launches {r0['launches']} / "
                f"{r1['launches']} / {ref['launches']}; the ranks' states bit-equal {equal}")
            if not (equal and r0["launches"] == r1["launches"] == ref["launches"]):
                raise AssertionError(f"{tag}: ranks disagree or launched other kernels")
            for k, n in r0["launches"].items():
                key = k if dtype == "bfloat16" else f"{k} (fp32)"
                launched_b[key] = launched_b.get(key, 0) + n
        for r in (two[0][-2], two[1][-2]):
            for line in r["lines"][:6]:
                log(line.replace("[profile]", f"[parallel][rank {r['rank']}]"))
        t0_, t1_ = two[0][-2], two[1][-2]
        log(f"[parallel] (b) 2 gloo ranks on cuda:0, one SSP step (2 x 128, bf16, 64 per "
            f"rank): wall {t0_['wall_ms']:.2f} / {t1_['wall_ms']:.2f} ms, device "
            f"{t0_['device_ms']:.3f} / {t1_['device_ms']:.3f} ms by rank; the gloo all-reduce "
            f"alone ({t0_['grad_mb']:.1f} MiB) {t0_['allreduce_ms']:.3f} / "
            f"{t1_['allreduce_ms']:.3f} ms; copies in the step {t0_['comm']}; the launch took "
            f"{two_s:.1f} s; on {card}")

        # (c) the dry run's stages, run by (b)'s ranks after their steps
        lines = two[0][-1]
        for line in lines:
            log(f"[parallel] (c) rank 0: {line}")
        if len(lines) != 3 or not lines[2].endswith("tp_sharded_leaves=27"):
            raise AssertionError(f"the dry run on 2 ranks: {lines}")

    log(f"[parallel] phase 13 in {time.perf_counter() - t_phase:.1f} s")
    return launched_b


def replace_cfg(cfg, **kw):
    from vit2spn_tpu_torch.core.config import replace

    return replace(cfg, **kw)


def fit_path(tcfg, tds, impl, merged, per_step, trainer=None) -> tuple:
    """`fit` of one epoch over `tds` through one backbone path, with the
    launch counters set to 0 just before and read just after; every counter
    must read `per_step` (missing: 0) times the steps. A new trainer of
    `tcfg`, or `trainer` (set to `tcfg` and `impl` by the caller). Returns
    (trainer, launches, seconds)."""
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    os.environ["VIT2SPN_MERGED_BWD"] = "1" if merged else "0"
    if trainer is None:
        trainer = SSPTrainer(tcfg, logger=MetricLogger(echo=False), attn_impl=impl,
                             device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    history = trainer.fit(tds, epochs=1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = read_launches()
    eff = tcfg.effective_batch
    n_steps = len(tds) // eff
    name = f"{impl}{' merged' if merged else ''}{' fp32' if tcfg.compute_dtype == 'float32' else ''}"
    log(f"[train] {name}: fit of {n_steps} optimizer steps of {eff} images in {fit_s:.2f} s "
        f"({len(tds) / fit_s:.1f} img/s, first step included); epoch loss "
        f"{history[0]:.6f}; launches {launches}")
    if len(history) != 1 or not np.isfinite(history[0]):
        raise AssertionError(f"{name}: training loss is not finite: {history}")
    for k, n in launches.items():
        if n != per_step.get(k, 0) * n_steps:
            raise AssertionError(f"{name}: {k} launched {n} times in {n_steps} steps, "
                                 f"expected {per_step.get(k, 0)} per step")
    return trainer, launches, fit_s


def time_steps(trainer, eff, name, card, wrappers, rest, reps=3, totals=None) -> float:
    """The optimizer step's wall time over `reps` steps after a warm-up, and
    its device time by wrapper range (`rest` names what runs outside the
    wrappers; `totals` as stage_breakdown's). Returns the step's seconds."""
    idx = np.arange(eff)
    trainer.train_step_indices(idx, (1, 0))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for r in range(reps):
        trainer.train_step_indices(idx, (1, 1 + r))
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / reps
    cfg = trainer.cfg
    log(f"[time] optimizer step {name} (dual stream, {cfg.accumulation_steps} x "
        f"{cfg.batch_size}, {cfg.compute_dtype}): "
        f"{1e3 * step_s:.2f} ms, {eff / step_s:.1f} img/s over {reps} steps on {card}")
    for line in stage_breakdown(lambda: trainer.train_step_indices(idx, (1, 10)),
                                f"one optimizer step ({name})", wrappers=wrappers, rest=rest,
                                totals=totals):
        log(line)
    return step_s


def extract_path(trainer, ds, impl, feats_plain, want, tol=FEATURE_REL_TOL,
                 what=None) -> np.ndarray:
    """extract_features through one backbone path, with the launch counters
    set to 0 just before and read just after: the kernels in `want` must
    have run and no other; the features must be finite and agree with the
    plain path's within `tol` of their largest magnitude. Returns the
    features."""
    what = what or impl
    trainer.attn_impl = impl
    reset_launches()
    t0 = time.perf_counter()
    feats, _ = trainer.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    launches = {k: n for k, n in read_launches().items() if n}
    scale = float(np.abs(feats_plain).max())
    err = float(np.abs(feats - feats_plain).max())
    log(f"[extract] {what}: {feats.shape} features, launches {launches}, {extract_s:.3f} s, "
        f"{len(ds) / extract_s:.1f} img/s; vs plain max_abs_err {err:.6g} (max |plain| "
        f"{scale:.4g}, tol {tol} relative)")
    if set(launches) != set(want):
        raise AssertionError(f"extract through {what} launched {launches}, expected {want}")
    if feats.shape != feats_plain.shape or not np.isfinite(feats).all():
        raise AssertionError(f"bad features through {what}: shape {feats.shape}")
    if not err <= tol * scale:
        raise AssertionError(f"features through {what} disagree with the plain path")
    return feats


def flash_bound_ms(kind, b, s, heads, fp32=False, dh=64) -> tuple:
    """Least time for one attention forward or backward over (b, s, heads,
    dh) bf16 (or fp32): the products it needs (forward Q K^T and P V;
    backward Q K^T recomputed, dV, dP, dQ, dK; each 2 S^2 dh per (image,
    head)) over the bf16 peak (the fp32 peak outside the tensor cores), vs
    q, k, v (and dO) read once and o (dq, dk, dv) written once. Returns (ms,
    "operations" | "bytes", flops)."""
    products, tensors = (2, 4) if kind == "fwd" else (5, 7)
    flops = b * heads * products * 2 * s * s * dh
    nbytes = tensors * b * s * heads * dh * (4 if fp32 else 2)
    t_ops = flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def library_flash_bwd(q, k, v, do, dtype=None):
    """SDPA's autograd backward on (B, H, S, Dh) copies of q, k, v (in
    `dtype`, default theirs; yardstick only): returns a function that runs
    the backward alone, and the forward's output."""
    leaves = [t.transpose(1, 2).to(dtype or t.dtype).contiguous().requires_grad_(True)
              for t in (q, k, v)]
    out = F.scaled_dot_product_attention(*leaves)
    dot = do.transpose(1, 2).to(dtype or do.dtype).contiguous()
    return (lambda: torch.autograd.grad(out, leaves, dot, retain_graph=True)), out.detach()


def check_same_fn_yardstick(q, k, v, do):
    """SDPA on fp32 copies of q, k, v (P and dS in fp32, the Pallas body's
    function, outputs left in fp32): its mean error against float64 beside
    the plain twin's on the same fp32 inputs, so a bf16 P or TF32 inside it
    shows. Returns (forward, backward) functions to time, the copies made
    outside them."""
    from vit2spn_tpu_torch.ops import flash_attention as fa

    copies = [t.transpose(1, 2).float().contiguous() for t in (q, k, v)]
    bwd, out = library_flash_bwd(q, k, v, do, torch.float32)
    got = (out, *bwd())
    ref64 = attention_fp64(q, k, v, do)
    f32 = [t.float() for t in (q, k, v, do)]
    twin = (fa.flash_attention_plain(*f32[:3]), *fa.flash_attention_bwd_plain(*f32))
    errs = [f"{n} {mean_rel64(a.transpose(1, 2), c):.4g}/{mean_rel64(b, c):.4g}"
            for n, a, b, c in zip(("o", "dq", "dk", "dv"), got, twin, ref64)]
    log(f"[library-same-fn] SDPA on fp32 copies, B={q.shape[0]} S={q.shape[1]}: mean error "
        f"vs float64, SDPA / the plain twin on the same fp32 copies: {', '.join(errs)} "
        "(yardstick only; TF32 or a bf16 P would put SDPA far above the twin)")
    return (lambda: F.scaled_dot_product_attention(*copies)), bwd


# Phase 14: the model zoo. The JAX package's other backbone geometries
# (vit2spn_tpu/core/config.py ViTConfig.small / base), selected by
# `-o vit=small|base`, at full width: (name, preset value, D, heads, mlp).
ZOO = (("ViT-Small", "small", 384, 6, 1536), ("ViT-Base", "base", 768, 12, 3072))


# (a)'s shapes at each width: (B, S, fast gelu); the fp32 reference at B=128,
# the determinism and launch checks at the last
ZOO_SHAPES = ((7, 197, False), (3, 17, True), (2, 256, False), (128, 197, False),
              (128, 197, True))
# CUDA launches of one call on the wide routes, none of common.cuh's mma.sync
# GEMM: the backward's (csrc/*_bwd.cu) split halves 7 each, merged one
# reduction fewer; the forward's (csrc/layer_fwd.cuh) 7 a layer, 12 layers in
# one backbone call
ZOO_CUDA_LAUNCHES = {"mlp_bwd": 7, "attn_bwd": 7, "merged_bwd": 13, "backbone_fwd": 84,
                     "layer_fwd": 7}
# (a)'s forward also at D = 512 (8 heads, mlp 2048), ragged B: there Wo, W2
# (N = 512) and W1 (N = 2048) are no multiple of 192, so tile_gemm takes its
# 128-column tiles
ZOO_FWD_EXTRA = ("D=512", 512, 8, 2048, ((7, 197, False), (3, 17, True)))
# (a)'s 12-layer backbone forward vs its twin, relative to the twin's largest
# magnitude (the phase's backward tolerances): phase 3's absolute bounds were
# set at ViT-Tiny, where the two sit 1.3e-3 apart on average. At wider D the
# two bf16 computations drift further apart over 12 layers while each stays
# as far from the fp32 forward as the other (H100, mean over the outputs:
# 3.3e-3 apart at ViT-Small, 7.8e-3 at ViT-Base, each 4.9e-3 / 7.7e-3 from
# fp32; the route before tile_gemm read the same to 2 digits). So every shape
# also holds the kernel as close to fp32 as the twin (KERNEL_VS_FP32_RATIO).
ZOO_FWD_REL_TOL = (2e-2, 2e-3)
ZOO_TRAIN_IMAGES = 2048  # (b): two optimizer steps of 8 x 128 per width
ZOO_TRAIN_LAYERS = 6  # (b): cut from 12 for the script's time (phase 18 trains 24)
ZOO_EXTRACT_IMAGES = 1024  # (c): four batches of 256
ZOO_CLI_SPLITS = {"train": 3072, "val": 256, "test": 512}  # (d): three SSP steps
ZOO_FT_FOLDS = 2
# (b)'s loss: both bf16 paths land ~1.5% from the fp32 step's loss at
# ViT-Small on the H100 (5e-4 of -0.036), in the same direction, and 5e-5
# apart. One scalar is one sample of that rounding, so it is not held to
# the 5% ratio of the moments' relative L2 (millions of elements): the fused
# loss may sit at most twice as far from the fp32 step's as the "xla" loss,
# far inside the error of a forward that computed another function.
ZOO_LOSS_VS_FP32 = 2.0


def zoo_kernels(fb, dev) -> dict:
    """Phase 14 (a): at each ZOO width and ZOO_SHAPES, mlp_bwd and attn_bwd
    against their twins (and as close to fp32 as the twins at B=128), merged
    against the split pair bit for bit and its twin; two runs of each giving
    equal bits; one call of each with its counter, its CUDA launches
    (ZOO_CUDA_LAUNCHES) and no `gemm_kernel` (common.cuh's mma.sync GEMM) in
    its trace. Returns {D: {kernel: largest absolute difference from the
    twin}}."""
    eps, errs = 1e-12, {}
    for label, _, d, heads, mlp in ZOO:
        gen = torch.Generator().manual_seed(SEED + 14 + d)
        w = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d, mlp, dev))
        worst = {"mlp_bwd": 0.0, "attn_bwd": 0.0, "merged_bwd": 0.0}
        for b, s, fast in ZOO_SHAPES:
            x, x2, g = (torch.randn(b, s, d, generator=gen) for _ in range(3))
            x, x2, g = (t.to(torch.bfloat16).to(dev) for t in (x, x2, 0.1 * g))
            tag = f"{label} B={b} S={s} D={d} heads={heads} mlp={mlp} fast_gelu={fast}"
            for k, v in check_layer_bwd(tag, fb, x, g, w, heads, eps, fast,
                                        against_fp32=b == TRAIN_BATCH).items():
                worst[k] = max(worst[k], v)
            worst["merged_bwd"] = max(worst["merged_bwd"], check_merged_bwd(
                tag, fb, x, x2, g, w, heads, eps, fast, True))
        calls = {"mlp_bwd": lambda: fb.mlp_bwd(x2, g, w, eps, True),
                 "attn_bwd": lambda: fb.attn_bwd(x, g, w, heads, eps),
                 "merged_bwd": lambda: fb.merged_bwd(x, x2, g, w, heads, eps, True)}
        for name, fn in calls.items():
            check_zoo_call(f"{label} {name} B={b} S={s}", name, fn, d,
                           fb.cuda_launches(name, None, d, 0, heads=heads, mlp=mlp))
        errs[d] = worst
        del w, x, x2, g
        torch.cuda.empty_cache()
    return errs


def tensors_of(out) -> list:
    """The tensors of a wrapper's result (a tensor, or tuples and dicts of
    them), in order."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        return [t for k in sorted(out) for t in tensors_of(out[k])]
    return [t for o in out for t in tensors_of(o)]


def check_zoo_call(tag, name, fn, d, n_cuda, want=None) -> None:
    """Phase 14 (a)'s (and 18 (a)'s) checks of one wrapper call `fn` of
    kernel `name` at width d: two runs give equal bits; one call raises its
    counter by 1 and no other; the C entry point's CUDA launches (`n_cuda`)
    equal `want` (ZOO_CUDA_LAUNCHES by default); no `gemm_kernel`
    (common.cuh's mma.sync GEMM) in a trace of STAGE_CALLS calls (the trace
    may drop a run's first launches)."""
    want = ZOO_CUDA_LAUNCHES[name] if want is None else want
    runs = [tensors_of(fn()) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs
    reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = read_launches()
    totals = {}
    stage_breakdown(lambda: [fn() for _ in range(STAGE_CALLS)], totals=totals)
    mma_sync = [k for k in totals.get("kernels", {}) if k.startswith("void gemm_kernel<")]
    log(f"[zoo] {tag}: two runs bitwise equal {same}; one call: counter {counts[name]}, "
        f"{n_cuda} CUDA launches (want {want}); kernels traced over "
        f"{STAGE_CALLS} calls {sorted(k.split('(')[0] for k in totals.get('kernels', {}))}")
    if not same:
        raise AssertionError(f"{name} at D={d} is not deterministic")
    if counts[name] != 1 or any(n for k, n in counts.items() if k != name):
        raise AssertionError(f"one {name} call at D={d} launched {counts}")
    if n_cuda != want or mma_sync or "kernels" not in totals:
        raise AssertionError(f"{name} at D={d}: {n_cuda} CUDA launches, mma.sync GEMMs "
                             f"{mma_sync}, traced {totals.get('kernels')}")


def zoo_forward(fb, dev) -> dict:
    """Phase 14 (a), the forward's wide route: at each ZOO width and
    ZOO_SHAPES, and at ZOO_FWD_EXTRA, fused_backbone (12 layers, with and
    without emit_res) against its twin under ZOO_FWD_REL_TOL and as close to
    fp32 as the twin, layer_fwd against its twin under phase 3's tolerances
    and at B=128 as close to fp32 as the twin; 12 fused_block
    calls equal to one fused_backbone bit for bit; two runs of each giving
    equal bits; one call of each with its counter, its CUDA launches
    (ZOO_CUDA_LAUNCHES) and no `gemm_kernel` (common.cuh's mma.sync GEMM) in
    its trace. Returns {D: {kernel: largest absolute difference from the
    twin}}."""
    eps, errs = 1e-12, {}
    widths = [(label, d, heads, mlp, ZOO_SHAPES) for label, _, d, heads, mlp in ZOO]
    for label, d, heads, mlp, shapes in widths + [ZOO_FWD_EXTRA]:
        gen = torch.Generator().manual_seed(SEED + 140 + d)
        wt = random_backbone(gen, 12, d, mlp, dev)
        w0 = tuple(t[0] for t in wt)
        worst = {"backbone_fwd": 0.0, "layer_fwd": 0.0}
        for b, s, fast in shapes:
            x = torch.randn(b, s, d, generator=gen).to(torch.bfloat16).to(dev)
            tag = f"{label} B={b} S={s} D={d} heads={heads} mlp={mlp} fast_gelu={fast}"
            worst["backbone_fwd"] = max(worst["backbone_fwd"], check_backbone_fwd(
                tag, fb, x, wt, heads, eps, fast))
            worst["layer_fwd"] = max(worst["layer_fwd"], check_layer_fwd(
                tag, fb, x, w0, heads, eps, fast, b == TRAIN_BATCH))
        with torch.no_grad():
            h = x
            for l in range(12):
                h = fb.fused_block(h, tuple(t[l] for t in wt), heads, eps, fast)
            hb = fb.fused_backbone(x, wt, heads, eps, fast)
            torch.cuda.synchronize()
        share = equal_bits(h, hb)
        log(f"[zoo] {label} B={b} S={s} fast_gelu={fast}: 12 fused_block calls vs one "
            f"fused_backbone: {100.0 * share:.4f}% of the outputs equal bit for bit (must be "
            f"100%: one layer code)")
        if share != 1.0:
            raise AssertionError(f"the per-layer forward differs from the backbone at D={d}")
        calls = {"backbone_fwd": lambda: fb.fused_backbone(x, wt, heads, eps, fast, True),
                 "layer_fwd": lambda: fb.layer_fwd(x, w0, heads, eps, fast)}
        n_cuda = {"backbone_fwd": 12 * fb.kernel_launches_per_layer(d, False, heads, mlp),
                  "layer_fwd": fb.cuda_launches("layer_fwd", None, d, 0, heads=heads, mlp=mlp)}
        for name, fn in calls.items():
            check_zoo_call(f"{label} {name} B={b} S={s}", name, fn, d, n_cuda[name])
        errs[d] = worst
        del wt, w0, x, h, hb
        torch.cuda.empty_cache()
    return errs


def state_copy(tree):
    """A copy on the card of a trainer state's tensors (params, Adam's
    moments and count, the step), the structure kept."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: state_copy(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[state_copy(v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(state_copy(v) for v in tree)
    return tree


def flat_tensors(tree, prefix="") -> dict:
    """{path: tensor} of a nested dict or tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return {k: v for key, sub in items for k, v in flat_tensors(sub, f"{prefix}/{key}").items()}


def use_path(tr, cfg, impl) -> None:
    """Point one trainer at a backbone path and a config's compute dtype
    (its params are fp32 whatever the compute dtype, so one state serves
    every path)."""
    from vit2spn_tpu_torch.core.dtypes import DTypePolicy

    tr.cfg, tr.policy, tr.attn_impl = cfg, DTypePolicy.from_str(cfg.compute_dtype), impl


def zoo_step_check(tr, cfg, images, label) -> None:
    """Phase 14 (b)'s (and 15 (b)'s, 18 (b)'s) step 1 from one state
    through "fused", through "xla" (the per-op path: bf16 ops, rounded at
    other points than the fused function) and through "xla" under
    compute_dtype=float32, exact gelu on all three, "xla" with full remat
    (so its autograd fits the card). One trainer `tr` of `cfg`: its state is
    copied on the card and restored before each path and after the last (a
    new trainer a path would draw its random init on the host three
    times). "fused" against "xla": Adam's first moments and the updated
    params under compare_steps' tolerances. Against the fp32 step: "fused"
    at least as close as "xla", within KERNEL_VS_FP32_RATIO, in the first
    moments' relative L2 (all trainable leaves, and the blocks the backward
    kernels compute), and its loss within ZOO_LOSS_VS_FP32 times the "xla"
    loss's distance from the fp32 step's. (Phase 9's
    fused-vs-plain loss tolerance does not carry over: the two bf16 paths
    round at other points, and the loss of random features sits near 0.)
    Every comparison runs on the card, leaf by leaf in float64."""
    from vit2spn_tpu_torch.cli import _apply_overrides

    start = state_copy(tr.state)
    remat = _apply_overrides(cfg, ["vit.remat=full"])
    gelu_env = os.environ.get("VIT2SPN_FAST_GELU")
    os.environ["VIT2SPN_FAST_GELU"] = "0"
    runs = {}
    try:
        for name, rcfg, impl in (("fused", cfg, "fused"), ("xla", remat, "xla"),
                                 ("fp32", replace_cfg(remat, compute_dtype="float32"), "xla")):
            tr.state = start
            use_path(tr, rcfg, impl)
            loss = float(tr.train_step(images, (0, 0))["loss"])
            st = tr.state
            runs[name] = (loss, state_copy(flat_tensors(st.opt_state[0]["mu"], "mu")),
                          state_copy(flat_tensors((st.params.online, st.params.heads), "params")))
    finally:
        if gelu_env is None:
            os.environ.pop("VIT2SPN_FAST_GELU")
        else:
            os.environ["VIT2SPN_FAST_GELU"] = gelu_env
    tr.state = start
    use_path(tr, cfg, "fused")
    before = flat_tensors((start.params.online, start.params.heads), "params")

    def l2(a, b, keys):
        num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in keys)
        return math.sqrt(num / sum(float((b[k].double() ** 2).sum()) for k in keys))

    (lf, muf, pf), (lx, mux, px), (l32, mu32, _) = runs["fused"], runs["xla"], runs["fp32"]
    blocks = [k for k in mu32 if "/blocks/" in k]
    dist = {n: (l2(m, mu32, list(mu32)), l2(m, mu32, blocks)) for n, m in (("fused", muf),
                                                                           ("xla", mux))}
    worst = max(float((muf[k] - mux[k]).abs().max()) / float(mux[k].abs().max())
                for k in mux if float(mux[k].abs().max()) > 0)
    same = total = 0
    lim = cfg.learning_rate * (1 + 1e-3) + 1e-7  # Adam's first step, fp32 rounding
    for k in before:
        da, db = pf[k] - before[k], px[k] - before[k]
        if float(da.abs().max()) > lim or float(db.abs().max()) > lim:
            raise AssertionError(f"{k}: a step larger than the learning rate")
        same += int((torch.sign(da) == torch.sign(db)).sum())
        total += da.numel()
    fused_xla = l2(muf, mux, list(mux))
    log(f"[zoo-step1] {label}: loss fused {lf:.6f}, xla {lx:.6f}, xla fp32 {l32:.6f}; Adam "
        f"first moments' relative L2 from the fp32 step, all leaves / the blocks: fused "
        f"{dist['fused'][0]:.4f} / {dist['fused'][1]:.4f}, xla {dist['xla'][0]:.4f} / "
        f"{dist['xla'][1]:.4f} (ratio tol {KERNEL_VS_FP32_RATIO}; the loss's "
        f"{ZOO_LOSS_VS_FP32}); fused vs xla: moments' largest difference {worst:.3g} of the "
        f"leaf's largest, relative L2 {fused_xla:.3g} (tol {STEP_MU_MAX_REL_TOL}, "
        f"{STEP_MU_L2_REL_TOL}); params moved the same way in {100.0 * same / total:.2f}% of "
        f"{total} (tol {100.0 * STEP_SAME_DIRECTION_MIN:.0f}%)")
    if not (np.isfinite(lf) and abs(lf - l32) <= ZOO_LOSS_VS_FP32 * abs(lx - l32)):
        raise AssertionError(f"{label} step 1 loss: fused {lf}, xla {lx}, fp32 {l32}")
    if not all(dist["fused"][i] <= KERNEL_VS_FP32_RATIO * dist["xla"][i] for i in range(2)):
        raise AssertionError(f"{label} step 1: fused is further from the fp32 step than xla "
                             f"({dist})")
    if not (worst <= STEP_MU_MAX_REL_TOL and fused_xla <= STEP_MU_L2_REL_TOL
            and same >= STEP_SAME_DIRECTION_MIN * total):
        raise AssertionError(f"{label} step 1 of fused disagrees with xla")
    del start, runs, before


def zoo_training(card) -> dict:
    """Phase 14 (b): SSP training at each ZOO width through the CLI's
    overrides (`ssp-scratch`, `-o vit=<name>`: ZOO_TRAIN_LAYERS of 12
    layers, 224 px, 8 x 128, bf16) on 28 px synthetic sources, one trainer
    a width: step 1 of "fused" against "xla" and the fp32 step
    (zoo_step_check; full remat on "xla", so its autograd fits the card:
    the plain twin's fp32 autograd at B=128 would not); `fit` of two steps
    through "fused", then
    one merged step, each with the counters read around it; each path's
    step wall, img/s, device time by wrapper and card idle. Returns {D:
    {kernel: launches}}."""
    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    tds = synthetic_dataset(split_sizes={"train": ZOO_TRAIN_IMAGES}, image_size=28,
                            seed=SEED + 14).split("train")
    launches, rest = {}, "views, embed, heads, loss, Adam, EMA"
    for label, vit, d, heads, mlp in ZOO:
        cfg = _apply_overrides(get_preset("ssp-scratch"),
                               [f"vit={vit}", f"vit.num_layers={ZOO_TRAIN_LAYERS}"])
        geom = (cfg.vit.hidden_size, cfg.vit.num_heads, cfg.vit.mlp_dim, cfg.vit.num_layers,
                cfg.vit.image_size, cfg.batch_size, cfg.compute_dtype)
        if geom != (d, heads, mlp, ZOO_TRAIN_LAYERS, 224, TRAIN_BATCH, "bfloat16"):
            raise AssertionError(f"-o vit={vit} gave {geom}")
        eff, a, layers = cfg.effective_batch, cfg.accumulation_steps, cfg.vit.num_layers
        log(f"[zoo] {label} SSP training: D={d}, {heads} heads, mlp {mlp}, {layers} layers "
            f"(cut from 12), {a} x {cfg.batch_size}, {cfg.compute_dtype}")
        tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), attn_impl="fused", device="cuda")
        zoo_step_check(tr, cfg, tds.images[:eff], label)
        got = {}
        for merged, images in ((False, tds), (True, tds.subset(np.arange(eff)))):
            bwd = ({"merged_bwd": 2 * a * layers} if merged
                   else {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers})
            per_step = {KERNEL_NAME: 2 * 2 * a, **bwd}
            trainer, n, _ = fit_path(cfg, images, "fused", merged, per_step, trainer=tr)
            got.update({k: v for k, v in n.items() if v})
            totals = {}
            name = f"fused{' merged' if merged else ''} {label}"
            step_s = time_steps(trainer, eff, name, card, tuple(per_step), rest, reps=2,
                                totals=totals)
            log(f"[zoo] {name} step: wall {1e3 * step_s:.2f} ms, {eff / step_s:.1f} img/s, "
                f"device {totals.get('device', float('nan')):.3f} ms, card idle "
                f"{100 * (1 - totals.get('device', float('nan')) / (1e3 * step_s)):.1f}% on "
                f"{card}")
            os.environ["VIT2SPN_MERGED_BWD"] = "0"
        del tr, trainer
        gc.collect()
        torch.cuda.empty_cache()
        launches[d] = got
    return launches


def zoo_extract(card) -> None:
    """Phase 14 (c): extract_features at batch 256 at each ZOO width
    (`ssp-scratch`, `-o vit=<name>`) over ZOO_EXTRACT_IMAGES 28 px sources:
    the counters around it (the backbone kernel only), finite features that
    agree with the plain path's, img/s and the forward's device time."""
    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    ds = synthetic_dataset(split_sizes={"all": ZOO_EXTRACT_IMAGES}, image_size=28, seed=SEED)
    for label, vit, d, _, _ in ZOO:
        cfg = _apply_overrides(get_preset("ssp-scratch"), [f"vit={vit}"])
        trainer = SSPTrainer(cfg, logger=MetricLogger(echo=False), device="cuda")
        trainer.extract_features(ds, batch_size=BATCH)  # warm-up
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        feats, _ = trainer.extract_features(ds, batch_size=BATCH)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = {k: n for k, n in read_launches().items() if n}
        totals = {}
        lines = stage_breakdown(lambda: trainer.extract_features(ds, batch_size=BATCH),
                                f"{label} extract of {len(ds)} images", top=6,
                                wrappers=(KERNEL_NAME,), rest="views, embed, heads",
                                totals=totals)
        trainer.attn_impl = "plain"
        plain, _ = trainer.extract_features(ds, batch_size=BATCH)
        scale, err = float(np.abs(plain).max()), float(np.abs(feats - plain).max())
        log(f"[zoo] {label} extract: {feats.shape} features in {secs:.3f} s, "
            f"{len(ds) / secs:.1f} img/s, launches {launches}; forward device time "
            f"{totals.get('vit2spn::' + KERNEL_NAME, float('nan')):.3f} ms of "
            f"{totals.get('device', float('nan')):.3f} ms; vs plain max_abs_err {err:.6g} "
            f"(max |plain| {scale:.4g}, tol {FEATURE_REL_TOL} relative) on {card}")
        for line in lines:
            log(line)
        if set(launches) != {KERNEL_NAME}:
            raise AssertionError(f"{label} extract launched {launches}")
        if feats.shape != (len(ds), cfg.proj_dim) or not np.isfinite(feats).all():
            raise AssertionError(f"{label} extract: bad features {feats.shape}")
        if not err <= FEATURE_REL_TOL * scale:
            raise AssertionError(f"{label} features disagree with the plain path")
        del trainer
        torch.cuda.empty_cache()


def stage_octmnist(tmp, splits, seed) -> None:
    """An octmnist.npz of 28 px synthetic sources with `splits` in tmp, as
    the loader reads the published file."""
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset

    ds = synthetic_dataset(image_size=28, seed=seed, split_sizes=splits)
    np.savez(os.path.join(tmp, "octmnist.npz"),
             **{f"{k}_images": ds.images[ds.splits[k], ..., 0] for k in ds.splits},
             **{f"{k}_labels": ds.labels[ds.splits[k], None] for k in ds.splits})


def zoo_cli(card) -> None:
    """Phase 14 (d): through the CLI at ViT-Small, on a staged octmnist.npz
    (ZOO_CLI_SPLITS): `run ssp-scratch -o vit=small` for one epoch, then
    `run ssp-ssl/ft-octmnist -o vit=small -o init=scratch -o
    init_path=<its export>` cut to ZOO_FT_FOLDS folds and 1 epoch, each with
    the counters read around it and held to the predicted launches."""
    import tempfile

    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.cli import main as cli_main
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import load_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME

    label, vit = ZOO[0][:2]
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        stage_octmnist(tmp, ZOO_CLI_SPLITS, SEED + 15)
        common = ["-o", f"vit={vit}", "-o", f"data.root={tmp}"]
        cfg = _apply_overrides(get_preset("ssp-scratch"), [f"vit={vit}", f"data.root={tmp}"])
        a, layers = cfg.accumulation_steps, cfg.vit.num_layers
        steps = ZOO_CLI_SPLITS["train"] // cfg.effective_batch
        want = {KERNEL_NAME: steps * 2 * 2 * a, "mlp_bwd": steps * 2 * a * layers,
                "attn_bwd": steps * 2 * a * layers}
        out = os.path.join(tmp, "ssp")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["run", "ssp-scratch", "--epochs", "1", "--output-dir", out, *common])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        export = os.path.join(out, cfg.export_name + ".npz")
        log(f"[zoo] {label} run ssp-scratch -o vit={vit}, 1 epoch of "
            f"{ZOO_CLI_SPLITS['train']} images ({steps} steps) in {secs:.1f} s: rc {rc}, "
            f"launches { {k: n for k, n in launches.items() if n} } (predicted {want})")
        if rc != 0 or not os.path.exists(export):
            raise AssertionError(f"run ssp-scratch -o vit={vit}: rc {rc}, export {export}")
        if launches != {k: want.get(k, 0) for k in launches}:
            raise AssertionError(f"run ssp-scratch -o vit={vit} launched {launches}, "
                                 f"predicted {want}")
        with np.load(export) as z:
            w1 = [z[k].shape for k in z.files if k.endswith("w1")]
        if w1 != [(layers, ZOO[0][2], ZOO[0][4])]:
            raise AssertionError(f"the export's w1 is {w1}")
        preset = "ssp-ssl/ft-octmnist"
        ft_over = [f"vit={vit}", f"data.root={tmp}", f"k_folds={ZOO_FT_FOLDS}", "init=scratch",
                   f"init_path={export}"]
        cfg_ft = _apply_overrides(get_preset(preset), ft_over)
        octm = load_dataset("octmnist", root=tmp, allow_synthetic=False)
        ft_steps, evals, n_cv, n_test = protocol_launches(cfg_ft, octm, 1)
        want = _wanted(ft_steps, evals, layers)
        out = os.path.join(tmp, "ft")
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        rc = cli_main(["run", preset, "--epochs", "1", "--output-dir", out,
                       *[x for o in ft_over for x in ("-o", o)]])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
        with open(os.path.join(out, "metrics.jsonl")) as f:
            events = [json.loads(line) for line in f]
        aucs = [e["mauc"] for e in events if e["event"] == "fold_result"]
        log(f"[zoo] {label} run {preset} -o vit={vit} from that export (cut: {ZOO_FT_FOLDS} "
            f"folds, 1 epoch; subset {n_cv}, test {n_test}) in {secs:.1f} s: rc {rc}, "
            f"{ft_steps} train steps, {evals} eval batches; fold mAUCs {aucs}; launches "
            f"{ {k: n for k, n in launches.items() if n} } (predicted {want}) on {card}")
        if rc != 0 or len(aucs) != ZOO_FT_FOLDS or not all(np.isfinite(aucs)):
            raise AssertionError(f"run {preset} -o vit={vit}: rc {rc}, fold mAUCs {aucs}")
        if launches != {k: want.get(k, 0) for k in launches}:
            raise AssertionError(f"run {preset} -o vit={vit} launched {launches}, "
                                 f"predicted {want}")


def zoo_path(fb, card, dev) -> list:
    """Phase 14, the model zoo: (a) the wide backward and forward routes
    against their twins, (b) SSP training, (c) extract, (d) the CLI chain at ViT-Small,
    (e) the times. Returns (e)'s {"kernels": [...]} entries."""
    t_phase = time.perf_counter()
    errs = zoo_kernels(fb, dev)
    for d, e in zoo_forward(fb, dev).items():
        errs.setdefault(d, {}).update(e)
    launches = zoo_training(card)
    zoo_extract(card)
    zoo_cli(card)
    entries = zoo_times(fb, card, dev, launches, errs)
    log(f"[zoo] phase 14 in {time.perf_counter() - t_phase:.1f} s")
    return entries


# The forward's GEMMs (csrc/layer_fwd.cuh) by their epilogue, common.cuh's
# EPI_* code; the row-block kit's (the route before tile_gemm) with the
# LayerNorm its A tile came from (ASRC 0: LN1 of bf16 x, 1: LN2 of fp32 x2)
FWD_GEMMS = {0: "QKV", 1: "Wo + residual", 2: "W1 + gelu", 3: "W2 + residual"}


def forward_stage(name: str, b, s, d, mlp):
    """(stage, FLOPs, bytes) of one launch of the forward's CUDA kernel
    `name` over B images: a GEMM's or the attention's FLOPs, a LayerNorm's
    bytes (its input read once, bf16 y written once); None for a kernel of
    no forward stage."""
    m = b * s
    flops = {0: 2 * m * d * 3 * d, 1: 2 * m * d * d, 2: 2 * m * d * mlp, 3: 2 * m * mlp * d}
    g = re.match(r"void gemm_kernel<false, false, ([0-3])>", name)
    if g:  # common.cuh's mma.sync GEMM (the general route): its epilogue names the stage
        return FWD_GEMMS[int(g.group(1))], flops[int(g.group(1))], 0
    g = re.match(r"void (tile_gemm_kernel|rowblock_gemm_kernel)<([^>]*)>", name)
    if g:
        args = [a.strip() for a in g.group(2).split(",")]
        if g.group(1) == "tile_gemm_kernel":
            return FWD_GEMMS[int(args[1])], flops[int(args[1])], 0
        ln = ("LN1 + ", "LN2 + ", "")[int(args[2])]
        return ln + FWD_GEMMS[int(args[3])], flops[int(args[3])], 0
    if "attention_kernel" in name or "gl_fwd_kernel" in name:
        return "attention", 4 * b * s * s * d, 0
    if name.startswith("void layernorm_kernel<__nv_bfloat16"):
        return "LN1", 0, 4 * m * d
    if name.startswith("void layernorm_kernel<float"):
        return "LN2", 0, 6 * m * d
    return None


def forward_by_stage(fn, b, s, d, mlp, label, card, calls: int = 3, layers: int = 12) -> None:
    """Phase 14 (e): a B-image backbone forward's device time by launch, from
    a torch.profiler trace of `calls` calls (the trace may drop a run's first
    launches, so each kernel's time a launch is its traced time over its
    traced launches), with each GEMM's and the attention's TFLOP/s and the
    LayerNorms' GB/s."""
    totals = {}
    stage_breakdown(lambda: [fn() for _ in range(calls)], totals=totals)
    rows = []
    for name, (ms, n) in totals.get("kernels", {}).items():
        stage = forward_stage(name, b, s, d, mlp)
        if stage is not None:
            rows.append((stage[0], ms / n, n, stage[1], stage[2]))
    if not rows:
        log(f"[zoo-stage] {label} forward B={b}: the trace holds no device time: not measured")
        return
    layer = sum(r[1] for r in rows)
    for stage, t, n, flops, nbytes in sorted(rows, key=lambda r: -r[1]):
        rate = (f"{flops / (t * 1e-3) / 1e12:.1f} TFLOP/s" if flops
                else f"{nbytes / (t * 1e-3) / 1e9:.0f} GB/s")
        log(f"[zoo-stage] {label} forward B={b}: {stage:18s} {t:.4f} ms a launch ({n} traced), "
            f"{100 * t / layer:.1f}% of a layer, {rate}; {card}")
    log(f"[zoo-stage] {label} forward B={b}: {len(rows)} launches a layer, {layer:.4f} ms, x "
        f"{layers} layers = {layers * layer:.3f} ms of device time; {card}")


def zoo_times(fb, card, dev, launches=None, errs=None, widths=None, s=197,
              b_layer=TRAIN_BATCH, fwd_iters=20, weights=None) -> list:
    """Phase 14 (e) (and 18 (d), 20 (d)): at each of `widths` ((label, D,
    heads, mlp, layers); default the ZOO widths at 12 layers), with CUDA
    events after a warm-up, backbone_fwd at B=256 and layer_fwd, mlp_bwd,
    attn_bwd and merged_bwd at B=`b_layer` (S=`s`, bf16; the backbone over
    `fwd_iters` calls, its twin over 3, or 1 below 20; on `weights` where
    given, one width's, else drawn): the kernel, its plain twin, its
    library yardstick and its bound; each backward's and the forward's
    device time by CUDA kernel. `launches` ({width: {kernel: n}}) and `errs`
    ({width: {kernel: max_abs_err}}) come from the phase's main path and
    checks (None: 0 and null, as when this runs alone through --zoo-times).
    Returns the {"kernels": [...]} entries."""
    entries = []
    eps, fast = 1e-12, True
    for label, d, heads, mlp, layers in widths or [(z[0], *z[2:], 12) for z in ZOO]:
        gen = torch.Generator().manual_seed(SEED + d)
        wt = weights if weights is not None else random_backbone(gen, layers, d, mlp, dev)
        x = torch.randn(BATCH, s, d, generator=gen).to(torch.bfloat16).to(dev)
        xb, x2b = (torch.randn(b_layer, s, d, generator=gen).to(torch.bfloat16).to(dev)
                   for _ in range(2))
        gb = (0.1 * torch.randn(b_layer, s, d, generator=gen)).to(torch.bfloat16).to(dev)
        wl = layer_weights(fb.WEIGHT_NAMES, wt)
        w0 = tuple(t[0] for t in wt)
        timed = (
            ("backbone_fwd", "backbone_fwd.cu", "vit2spn_tpu/ops/fused_block.py:694",
             backbone_bound_ms(BATCH, s, d, heads, mlp, layers, wt),
             layers * fb.kernel_launches_per_layer(d, False, heads, mlp),
             lambda: fb.fused_backbone(x, wt, heads, eps, fast),
             lambda: fb.backbone_forward_plain(x, wt, heads, eps, fast),
             lambda: library_backbone(x, wt, heads, eps)),
            ("layer_fwd", "layer_fwd.cu", "vit2spn_tpu/ops/fused_block.py:170",
             backbone_bound_ms(b_layer, s, d, heads, mlp, 1, w0, acts=3),
             fb.cuda_launches("layer_fwd", None, d, 0, heads=heads, mlp=mlp),
             lambda: fb.layer_fwd(xb, w0, heads, eps, fast),
             lambda: fb.layer_forward_plain(xb, w0, heads, eps, fast),
             lambda: library_backbone(xb, tuple(t[:1] for t in wt), heads, eps)),
            ("mlp_bwd", "mlp_bwd.cu", "vit2spn_tpu/ops/fused_block.py:342",
             bwd_bound_ms("mlp", b_layer, s, d, heads, mlp, wl),
             fb.cuda_launches("mlp_bwd", None, d, 0, heads=heads, mlp=mlp),
             lambda: fb.mlp_bwd(x2b, gb, wl, eps, fast),
             lambda: fb.mlp_bwd_plain(x2b, gb, wl, eps, fast),
             lambda: library_mlp_half(x2b, gb, wl, eps)),
            ("attn_bwd", "attn_bwd.cu", "vit2spn_tpu/ops/fused_block.py:357",
             bwd_bound_ms("attn", b_layer, s, d, heads, mlp, wl),
             fb.cuda_launches("attn_bwd", None, d, 0, heads=heads, mlp=mlp),
             lambda: fb.attn_bwd(xb, gb, wl, heads, eps),
             lambda: fb.attn_bwd_plain(xb, gb, wl, heads, eps),
             lambda: library_attn_half(xb, gb, wl, heads, eps)),
            ("merged_bwd", "merged_bwd.cu", "vit2spn_tpu/ops/fused_block.py:375",
             bwd_bound_ms("merged", b_layer, s, d, heads, mlp, wl),
             fb.cuda_launches("merged_bwd", None, d, 0, heads=heads, mlp=mlp),
             lambda: fb.merged_bwd(xb, x2b, gb, wl, heads, eps, fast),
             lambda: fb.merged_bwd_plain(xb, x2b, gb, wl, heads, eps, fast),
             lambda: library_attn_half(xb, library_mlp_half(x2b, gb, wl, eps)[0].to(xb.dtype),
                                       wl, heads, eps)),
        )
        for name, src, replaces, bound, n_cuda, kernel, twin, library in timed:
            b_ms, b_by, b_flops = bound
            iters = fwd_iters if name == "backbone_fwd" else 20
            k_ms = time_ms(kernel, iters=iters)
            p_ms = time_ms(twin, iters=3 if iters >= 20 else 1, warmup=1)
            with torch.no_grad() if name.endswith("fwd") else torch.enable_grad():
                l_ms = time_ms(library, iters=iters)
            batch = BATCH if name == "backbone_fwd" else b_layer
            tag = f"{name} (D={d})"
            log(f"[zoo-time] {label} {name} B={batch}: kernel {k_ms:.4f} ms ({n_cuda} CUDA "
                f"launches), plain twin {p_ms:.3f} ms, library {l_ms:.4f} ms, bound {b_ms:.4f} "
                f"ms ({b_by}; {b_flops / 1e9:.2f} GFLOP), kernel at "
                f"{b_flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, {100 * b_ms / k_ms:.1f}% of the "
                f"bound, library at {100 * b_ms / l_ms:.1f}%; {card}")
            entries.append({
                "name": tag, "route": "cuda", "source": f"vit2spn_tpu_torch/csrc/{src}",
                "replaces": replaces,
                "launches": (launches or {}).get(d, {}).get(name, 0),
                "max_abs_err": (errs or {}).get(d, {}).get(name),
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": l_ms, "cuda_launches": n_cuda, "dtype": "bfloat16",
            })
        forward_by_stage(timed[0][5], BATCH, s, d, mlp, label, card, layers=layers)
        for name, fn in (("mlp_bwd", timed[2][5]), ("attn_bwd", timed[3][5]),
                         ("merged_bwd", timed[4][5])):
            for line in stage_breakdown(lambda: [fn() for _ in range(STAGE_CALLS)],
                                        f"{label} {name} by stage, {STAGE_CALLS} calls", top=12):
                log(line)
        del wt, x, xb, x2b, gb, wl, w0, timed
        torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# Phase 15: inputs above 256 tokens. Above S = 256 the four bf16 attention
# kernels take csrc/long_attention.cuh's multi-pass routes: the forward
# layer's attention stage, the backward's attention core, the flash forward
# and backward. (a) holds each against its plain twin at these sequence
# lengths (257: the folder datasets at 256 px; 577: 384 px images; 785 and
# 1024 beyond) and widths (ViT-Tiny's D = 192 with 3 heads, ViT-Base's 768
# with 12), ragged batches:
LONG_SEQS = ((257, 5), (577, 3), (785, 2), (1024, 2))  # (S, B)
LONG_WIDTHS = (("D=192", 192, 3, 768), ("D=768", 768, 12, 3072))
# The stage and the core alone (their C entry points) against their twins
# (mha_plain; fused_block._attention_bwd): the same rounding points (bf16
# P, dS, outputs), sums in other orders, so an output near a bf16 boundary
# lands one step apart: the backward tolerances, relative to each output's
# largest magnitude (BWD_MAX_REL_TOL, BWD_MEAN_REL_TOL), and each as close
# to the same function in fp32 (the twin on fp32 copies) as the twin is
# (KERNEL_VS_FP32_RATIO, plus BWD_VS_FP32_SLACK). The core's att must equal
# the stage's bit for bit (one code for both: the same passes and sums).
# The flash pair: check_flash's tolerances (phase 5). The layers: 2-layer
# fused_backbone under ZOO_FWD_REL_TOL (phase 14's), attn_bwd and mlp_bwd
# under check_layer_bwd's, merged equal to the split pair bit for bit.
LONG_LAYERS = 2


def attention_stage_call(fb, qkv, heads):
    """The forward layer's attention stage alone (csrc/layer_fwd.cu
    vit2spn_attention_stage): att (B, S, D) from a bf16 qkv (B, S, 3D)."""
    b, s, d3 = qkv.shape
    att = torch.empty((b, s, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = fb._load("layer_fwd")
    fb._raise_on(lib, lib.vit2spn_attention_stage(qkv.data_ptr(), att.data_ptr(), b, s, heads,
                                                  d3 // 3, fb._stream(qkv.device)),
                 "attention stage")
    return att


def attention_core_call(fb, qkv, datt, heads):
    """The backward's attention core alone (csrc/attn_bwd.cu
    vit2spn_attention_core): (att, dqkv) from qkv and datt."""
    b, s, d3 = qkv.shape
    att = torch.empty_like(datt)
    dqkv = torch.empty_like(qkv)
    lib = fb._load("attn_bwd")
    fb._raise_on(lib, lib.vit2spn_attention_core(qkv.data_ptr(), datt.data_ptr(), att.data_ptr(),
                                                 dqkv.data_ptr(), b, s, heads, d3 // 3,
                                                 fb._stream(qkv.device)),
                 "attention core")
    return att, dqkv


def attention_stage_plain(qkv, heads):
    """The stage's twin: mha_plain over the heads of a (B, S, 3D) qkv."""
    from vit2spn_tpu_torch.ops.attention import mha_plain

    b, s, d3 = qkv.shape
    q, k, v = (t.reshape(b, s, heads, d3 // 3 // heads) for t in qkv.split(d3 // 3, dim=-1))
    return mha_plain(q, k, v).reshape(b, s, d3 // 3)


def check_rel(tag, names, got, ref, ref32, what="long") -> float:
    """Each output against its twin (BWD_*_REL_TOL of the twin's largest
    magnitude) and, unless `ref32` is None, as close to the fp32 function as
    the twin. Returns the largest absolute difference from the twin."""
    worst, worst_rel = 0.0, 0.0
    for i, (n, a, b) in enumerate(zip(names, got, ref)):
        mx_rel, mean_rel = rel_err(a, b)
        if not (mx_rel <= BWD_MAX_REL_TOL and mean_rel <= BWD_MEAN_REL_TOL):
            raise AssertionError(f"{tag}: {n} disagrees with its twin (max {mx_rel:.3g}, mean "
                                 f"{mean_rel:.3g} relative)")
        if ref32 is not None:
            e_k, e_t = rel_err(a, ref32[i])[1], rel_err(b, ref32[i])[1]
            if not e_k <= KERNEL_VS_FP32_RATIO * e_t + BWD_VS_FP32_SLACK:
                raise AssertionError(f"{tag}: {n} is further from fp32 than its twin ({e_k:.4g} "
                                     f"vs {e_t:.4g})")
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        worst_rel = max(worst_rel, mx_rel)
    log(f"[{what}-vs-plain] {tag}: largest relative difference {worst_rel:.3g} over "
        f"{', '.join(names)} (tol {BWD_MAX_REL_TOL}, {BWD_MEAN_REL_TOL})"
        + ("; vs fp32 within the twin" if ref32 is not None else ""))
    return worst


def long_kernels(fb, fa, dev) -> dict:
    """Phase 15 (a). Returns each route's largest absolute difference from
    its twin: {"attention_fwd", "attention_bwd", "flash_fwd", "flash_bwd"}."""
    eps = 1e-12
    errs = {"attention_fwd": 0.0, "attention_bwd": 0.0, "flash_fwd": 0.0, "flash_bwd": 0.0}
    for label, d, heads, mlp in LONG_WIDTHS:
        gen = torch.Generator().manual_seed(SEED + 15 + d)
        for s, b in LONG_SEQS:
            tag = f"{label} heads={heads} S={s} B={b}"
            # the stage and the core alone
            qkv = torch.randn(b, s, 3 * d, generator=gen).to(torch.bfloat16).to(dev)
            datt = (0.1 * torch.randn(b, s, d, generator=gen)).to(torch.bfloat16).to(dev)
            att_f = attention_stage_call(fb, qkv, heads)
            att_b, dqkv = attention_core_call(fb, qkv, datt, heads)
            torch.cuda.synchronize()
            errs["attention_fwd"] = max(errs["attention_fwd"], check_rel(
                f"attention stage {tag}", ("att",), (att_f,),
                (attention_stage_plain(qkv, heads),),
                (attention_stage_plain(qkv.float(), heads),)))
            ref = fb._attention_bwd(qkv, datt, heads)
            ref32 = fb._attention_bwd(qkv.float(), datt.float(), heads)
            names = ("att", "dq", "dk", "dv")
            thirds = lambda t: (t[0], *t[1].split(d, dim=-1))  # noqa: E731
            errs["attention_bwd"] = max(errs["attention_bwd"], check_rel(
                f"attention core {tag}", names, thirds((att_b, dqkv)), thirds(ref),
                thirds(ref32)))
            again = attention_core_call(fb, qkv, datt, heads)
            torch.cuda.synchronize()
            same_att = torch.equal(att_b, att_f)
            same = torch.equal(again[0], att_b) and torch.equal(again[1], dqkv)
            log(f"[long-bits] {tag}: core att = stage att bit for bit {same_att}; two core "
                f"runs equal {same}")
            if not (same_att and same):
                raise AssertionError(f"long attention bits ({tag}): att {same_att}, runs {same}")
            del qkv, datt, att_f, att_b, dqkv, ref, ref32, again
            # the flash pair
            for k_, v_ in check_flash(f"long {tag}", *flash_operands(
                    gen, b, s, heads, torch.bfloat16, dev)).items():
                errs[k_] = max(errs[k_], v_)
            ops = flash_operands(torch.Generator().manual_seed(SEED + s), b, s, heads,
                                 torch.bfloat16, dev)
            runs = [fa.flash_bwd(*ops) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(x_, y_) for x_, y_ in zip(*runs)):
                raise AssertionError(f"the flash backward is not deterministic ({tag})")
            del ops, runs
            # the layers through the wrappers
            wt = random_backbone(gen, LONG_LAYERS, d, mlp, dev)
            x = torch.randn(b, s, d, generator=gen).to(torch.bfloat16).to(dev)
            got = fb.fused_backbone(x, wt, heads, eps, True)
            torch.cuda.synchronize()
            mx_rel, mean_rel = rel_err(got, fb.backbone_forward_plain(x, wt, heads, eps, True))
            log(f"[long-vs-plain] fused_backbone {tag} L={LONG_LAYERS}: largest relative "
                f"difference {mx_rel:.3g}, mean {mean_rel:.3g} (tol {ZOO_FWD_REL_TOL})")
            if not (mx_rel <= ZOO_FWD_REL_TOL[0] and mean_rel <= ZOO_FWD_REL_TOL[1]):
                raise AssertionError(f"fused_backbone disagrees with its twin ({tag})")
            w = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d, mlp, dev))
            x2, g = (torch.randn(b, s, d, generator=gen) for _ in range(2))
            x2, g = x2.to(torch.bfloat16).to(dev), (0.1 * g).to(torch.bfloat16).to(dev)
            check_layer_bwd(tag, fb, x, g, w, heads, eps, True, against_fp32=s == 577)
            for name, fn in (("attn_bwd", lambda: fb.attn_bwd(x, g, w, heads, eps)),
                             ("merged_bwd", lambda: fb.merged_bwd(x, x2, g, w, heads, eps,
                                                                  True))):
                runs = [tensors_of(fn()) for _ in range(2)]
                torch.cuda.synchronize()
                same = all(torch.equal(a_, b_) for a_, b_ in zip(*runs))
                log(f"[long-bits] {tag}: two {name} runs equal bit for bit {same}")
                if not same:
                    raise AssertionError(f"{name} is not deterministic ({tag})")
                del runs
            check_merged_bwd(tag, fb, x, x2, g, w, heads, eps, True, True)
            del wt, x, x2, g, w, got
            torch.cuda.empty_cache()
    for dh in LONG_FAR_HEAD_DIMS:
        errs["flash_bwd"] = max(errs["flash_bwd"], long_flash_far(fa, dev, dh))
    return errs


# (a) also takes the flash backward (which takes any bf16 S) to S = 65,600,
# B = 1, one head (two at head_dim 16 and 80, for D a multiple of 32): past
# 2^16 keys a row sum l can exceed LA_QUOT_MAX_L, where the routes must take
# the IEEE division; at head_dim 64 (long_attention.cuh) and at 16 and 80
# (general_long.cuh, whose cols launch takes 64-query steps at 16-48 and
# 32-query steps at 80). The first half of the queries is scaled by 1e-5
# (scores near 0, so l near S, above 2^16), the rest as drawn. The twin's
# four S^2 matrices (17 GB each) cannot run whole: the reference is the
# twin's function in blocks of LONG_FAR_BLOCK queries (each row's softmax
# whole), held to check_flash's tolerances.
LONG_FAR_SEQ, LONG_FAR_BLOCK, LONG_FAR_HEAD_DIMS = 65600, 2048, (64, 16, 80)


def flash_bwd_blocked(q, k, v, do, rows=LONG_FAR_BLOCK):
    """`flash_attention_bwd_plain`'s function, fp32 inside, over blocks of
    `rows` queries: dq block by block, dk and dv summed over the blocks.
    Returns ((dq, dk, dv) in q.dtype, each query's row sum l in fp32, in
    (B, H, S) order)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = (torch.zeros_like(dq) for _ in range(2))
    sums = []
    for r0 in range(0, q.shape[1], rows):
        qb, ob = q[:, r0:r0 + rows].float(), do[:, r0:r0 + rows].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kf) * scale
        e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
        del s
        l = torch.sum(e, dim=-1, keepdim=True)
        p = e / l
        del e
        dv += torch.einsum("bhqk,bqhd->bkhd", p, ob)
        dp = torch.einsum("bqhd,bkhd->bhqk", ob, vf)
        ds = p * (dp - torch.sum(dp * p, dim=-1, keepdim=True))
        del p, dp
        dq[:, r0:r0 + rows] = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
        dk += torch.einsum("bhqk,bqhd->bkhd", ds, qb) * scale
        del ds
        sums.append(l[..., 0])
    return tuple(t.to(q.dtype) for t in (dq, dk, dv)), torch.cat(sums, dim=-1)


def long_flash_far(fa, dev, dh=64) -> float:
    """Phase 15 (a): one flash backward at LONG_FAR_SEQ and head_dim `dh`
    against flash_bwd_blocked (FLASH_TOL), with rows on both sides of l =
    2^16, and two runs' bits. Returns the largest absolute difference."""
    s, heads = LONG_FAR_SEQ, 32 // math.gcd(dh, 32)  # the wrapper takes D a multiple of 32
    gen = torch.Generator().manual_seed(SEED + s + dh - 64)
    q, k, v, do = flash_operands(gen, 1, s, heads, torch.bfloat16, dev, dh)
    q[:, :s // 2] *= 1e-5  # q is a view of the (1, S, 3 D) qkv: scaled in place
    got = fa.flash_bwd(q, k, v, do)
    torch.cuda.synchronize()
    ms = time_ms(lambda: fa.flash_bwd(q, k, v, do), iters=2, warmup=0)
    again = fa.flash_bwd(q, k, v, do)
    torch.cuda.synchronize()
    ref, sums = flash_bwd_blocked(q, k, v, do)
    over, rows = int((sums > 65536.0).sum()), sums.numel()
    max_tol, mean_tol = FLASH_TOL[torch.bfloat16]
    worst, errs = 0.0, []
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        mx, mean = rel_err(a, b)
        if not (mx <= max_tol and mean <= mean_tol):
            raise AssertionError(f"the flash backward at S = {s}, head_dim {dh} disagrees with "
                                 f"the blocked reference ({name}: max {mx:.3g}, mean "
                                 f"{mean:.3g} relative)")
        worst = max(worst, float((a.float() - b.float()).abs().max()))
        errs.append(f"{name} {mx:.3g}/{mean:.3g}")
    same = all(torch.equal(x_, y_) for x_, y_ in zip(got, again))
    log(f"[flash-far] flash backward at S={s} B=1 heads={heads} head_dim {dh} ({over} of {rows} "
        f"row sums above 2^16): largest / mean relative difference from the blocked fp32 reference {', '.join(errs)} "
        f"(tol {max_tol}, {mean_tol}); two runs equal bit for bit {same}; {ms:.3f} ms a call")
    if not same:
        raise AssertionError(f"the flash backward is not deterministic at S = {s}, head_dim {dh}")
    if not 0 < over < rows:
        raise AssertionError(f"at S = {s} {over} of {rows} row sums lie above 2^16: both sides "
                             f"must occur")
    del q, k, v, do, got, again, ref, sums
    torch.cuda.empty_cache()
    return worst


# The routes' branch-free quotient (long_attention.cuh LaQuot) against
# __fdiv_rn: pseudo-random pairs over a in [0, 1] (every exponent, the
# subnormals too) and l in [1, 2^16] (every exponent), plus 9 x 12 edges.
# Where the routes take it (a = 0 or a >= 2^-100, l <= 2^16) not one bit may
# differ; below, a warp takes the IEEE division, and the count there is
# recorded.
LONG_QUOTIENT_PAIRS, LONG_QUOTIENT_EDGES = 1 << 27, 9 * 12


def long_limits(fb, dev) -> None:
    """Phase 15 (a): the quotient probe, the scores' operand order, and the
    core's S limit on the card."""
    lib = fb._load("attn_bwd")
    counts = torch.zeros(4, dtype=torch.int64, device=dev)
    fb._raise_on(lib, lib.vit2spn_long_quotient_probe(LONG_QUOTIENT_PAIRS, counts.data_ptr(),
                                                      fb._stream(dev)), "quotient probe")
    bad, pairs, bad_low, low = counts.tolist()
    log(f"[long-quotient] branch-free a / l vs __fdiv_rn: {bad} of {pairs} pairs differ where "
        f"the routes take it (a = 0 or a >= 2^-100; l <= 2^16; edges included); below it "
        f"{bad_low} of "
        f"{low} differ (the routes' IEEE division there)")
    if bad or pairs + low != LONG_QUOTIENT_PAIRS + LONG_QUOTIENT_EDGES:
        raise AssertionError(f"the branch-free quotient differs from __fdiv_rn ({bad} pairs)")
    gen = torch.Generator().manual_seed(SEED + 16)
    same, total = 0, 0
    s_, st = (torch.empty(64, 64, device=dev) for _ in range(2))
    for _ in range(16):
        q, k = (torch.randn(64, 64, generator=gen).to(torch.bfloat16).to(dev) for _ in range(2))
        fb._raise_on(lib, lib.vit2spn_long_scores_probe(q.data_ptr(), k.data_ptr(), s_.data_ptr(),
                                                        st.data_ptr(), fb._stream(dev)),
                     "scores probe")
        torch.cuda.synchronize()
        same += int((s_ == st.T).sum())
        total += s_.numel()
    log(f"[long-scores] K Q^T (the core's key-major phase) vs Q K^T (its query passes) on "
        f"wgmma: {same} of {total} scores equal bit for bit")
    limit = lib.vit2spn_attention_core_max_seq(64)
    if limit != fb.LONG_CORE_MAX_SEQ:
        raise AssertionError(f"the core's S limit is {limit}, ops/fused_block.py says "
                             f"{fb.LONG_CORE_MAX_SEQ}")
    qkv = (0.5 * torch.randn(1, limit, 192, generator=gen)).to(torch.bfloat16).to(dev)
    datt = (0.1 * torch.randn(1, limit, 64, generator=gen)).to(torch.bfloat16).to(dev)
    got = attention_core_call(fb, qkv, datt, 1)
    torch.cuda.synchronize()
    names = ("att", "dq", "dk", "dv")
    thirds = lambda t: (t[0], *t[1].split(64, dim=-1))  # noqa: E731
    check_rel(f"attention core at its longest S={limit}", names, thirds(got),
              thirds(fb._attention_bwd(qkv, datt, 1)),
              thirds(fb._attention_bwd(qkv.float(), datt.float(), 1)))
    over = torch.zeros(1, limit + 1, 192, dtype=torch.bfloat16, device=dev)
    rc = lib.vit2spn_attention_core(over.data_ptr(), over[..., :64].contiguous().data_ptr(),
                                    over.data_ptr(), over.data_ptr(), 1, limit + 1, 1, 64,
                                    fb._stream(dev))
    try:
        fb._check_layer_inputs(over[..., :64].contiguous(), over[..., :64].contiguous(), {},
                               fb.ATTN_NAMES, 1, {})
        raised = ""
    except ValueError as e:
        raised = str(e)
    log(f"[long-limit] the core at S={limit} within the twin's tolerances; at S={limit + 1} "
        f"the C entry returns {rc} without a launch and the wrappers' check raises: {raised}")
    if rc == 0 or f"S <= {limit}" not in raised:
        raise AssertionError(f"S = {limit + 1} was not refused (rc {rc}, check {raised!r})")
    del qkv, datt, got, over
    torch.cuda.empty_cache()


def long_calls(fb, fa, dev, dtype=torch.bfloat16) -> None:
    """Phase 15 (a) (bf16) and 16 (a) (fp32), through the wrappers at S = 577
    (ViT-Base width): 12 `fused_block` calls equal one `fused_backbone` bit
    for bit; one call of each wrapper raises its own counter by 1 and its
    route's long-sequence count by its launches of the route (the backbone:
    one a layer), nothing else, with the C entry point's CUDA launches as at
    S <= 256."""
    eps, s, d, heads, mlp, layers = 1e-12, 577, 768, 12, 3072, 12
    fp32 = int(dtype == torch.float32)
    gen = torch.Generator().manual_seed(SEED + 1577)
    wt = tuple(t.float() if fp32 else t for t in random_backbone(gen, layers, d, mlp, dev))
    x = torch.randn(1, s, d, generator=gen).to(dtype).to(dev)
    h = x
    for l in range(layers):
        h = fb.fused_block(h, tuple(t[l] for t in wt), heads, eps, True)
    hb = fb.fused_backbone(x, wt, heads, eps, True)
    torch.cuda.synchronize()
    share = equal_bits(h, hb)
    log(f"[long-calls] {dtype} S={s} D={d}: {layers} fused_block calls vs one fused_backbone: "
        f"{100.0 * share:.4f}% of the outputs equal bit for bit (must be 100%)")
    if share != 1.0:
        raise AssertionError(f"at S = 577 the per-layer forward differs from the backbone's "
                             f"({dtype})")
    w = layer_weights(fb.WEIGHT_NAMES, tuple(t[:1] for t in wt))
    x2, g = (torch.randn(1, s, d, generator=gen) for _ in range(2))
    x2, g = x2.to(dtype).to(dev), (0.1 * g).to(dtype).to(dev)
    q, k, v, do = flash_operands(gen, 1, s, heads, dtype, dev)
    calls = (
        ("backbone_fwd", "attention_fwd", layers,
         fb.kernel_launches_per_layer(d, bool(fp32), heads, mlp) * layers,
         lambda: fb.fused_backbone(x, wt, heads, eps, True)),
        ("layer_fwd", "attention_fwd", 1, fb.cuda_launches("layer_fwd", None, d, fp32, heads=heads, mlp=mlp),
         lambda: fb.layer_fwd(x, tuple(t[0] for t in wt), heads, eps, True)),
        ("attn_bwd", "attention_bwd", 1, fb.cuda_launches("attn_bwd", None, d, fp32, heads=heads, mlp=mlp),
         lambda: fb.attn_bwd(x, g, w, heads, eps)),
        ("merged_bwd", "attention_bwd", 1, fb.cuda_launches("merged_bwd", None, d, fp32, heads=heads, mlp=mlp),
         lambda: fb.merged_bwd(x, x2, g, w, heads, eps, True)),
        ("flash_fwd", "flash_fwd", 1, fb.cuda_launches("flash_fwd", fa.KERNEL_NAME),
         lambda: fa.flash_fwd(q, k, v)),
        ("flash_bwd", "flash_bwd", 1, fb.cuda_launches("flash_bwd", fa.KERNEL_NAME),
         lambda: fa.flash_bwd(q, k, v, do)),
    )
    for name, route, n_route, n_cuda, fn in calls:
        reset_launches()
        fn()
        torch.cuda.synchronize()
        counts = {k_: n for k_, n in read_launches().items() if n}
        want = {name: 1, f"{route} (S>256)": n_route}
        log(f"[long-calls] one {dtype} {name} call at S={s}: counters {counts} (want {want}); "
            f"{n_cuda} CUDA launches, as at S <= 256")
        if counts != want:
            raise AssertionError(f"one {dtype} {name} call at S = {s} counted {counts}, not "
                                 f"{want}")


# (b): ViT-Base/16-384, the published fine-tuning geometry
# (google/vit-base-patch16-384: image 384, patch 16, hidden 768, 12 heads, 12
# layers, mlp 3072, S = 577), through the CLI's overrides of `ssp-scratch`,
# bf16. The steps are cut from 8 x 128 to LONG_MICRO x LONG_ACCUM images for
# the phase's time (the "xla" reference's scores alone are 1 GB a layer at
# 64 images), and the depth from 12 layers to LONG_TRAIN_LAYERS for the
# script's (phase 16 (b) takes the same cuts); extract takes LONG_EXTRACT
# images at batch LONG_EXTRACT_BATCH.
LONG_OVERRIDES = ("vit=base", "vit.image_size=384", "data.augment.out_size=384")
LONG_MICRO, LONG_ACCUM = 64, 2
LONG_TRAIN_LAYERS = 6
LONG_EXTRACT, LONG_EXTRACT_BATCH = 512, 128
# (c): `run ft-ucsdoct` at 256 px (S = 257), cut to 2 folds and 1 epoch,
# from random init (the pretrained and SSP inits are 224 px geometries)
LONG_FT_OVERRIDES = ("vit.image_size=256", "data.augment.out_size=256", "k_folds=2",
                     "init=random")


def long_training(card) -> dict:
    """Phase 15 (b), on one trainer: step 1 of "fused" against "xla" (and
    the fp32 "xla" step, zoo_step_check), then `fit` of two "fused" steps,
    one merged and one "pallas" step with the counters read around each
    (every wrapper and route exactly as predicted), the "fused" and
    "pallas" steps' device time by wrapper, and extract of LONG_EXTRACT
    images from the trained state against the plain path. Returns the
    long-sequence routes' launches summed over the four runs."""
    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    cfg = _apply_overrides(get_preset("ssp-scratch"), [
        *LONG_OVERRIDES, f"batch_size={LONG_MICRO}", f"accumulation_steps={LONG_ACCUM}",
        f"vit.num_layers={LONG_TRAIN_LAYERS}"])
    vit = cfg.vit
    geom = (vit.image_size, vit.hidden_size, vit.num_heads, vit.mlp_dim, vit.num_layers,
            vit.seq_len, cfg.compute_dtype)
    if geom != (384, 768, 12, 3072, LONG_TRAIN_LAYERS, 577, "bfloat16"):
        raise AssertionError(f"the ViT-Base/16-384 overrides gave {geom}")
    eff, a, layers = cfg.effective_batch, cfg.accumulation_steps, vit.num_layers
    log(f"[long] (b) ViT-Base/16-384 SSP: S={vit.seq_len}, D={vit.hidden_size}, "
        f"{a} x {cfg.batch_size} (cut from 8 x 128), {layers} layers (cut from 12), bf16")
    tds = synthetic_dataset(split_sizes={"train": 2 * eff}, image_size=28,
                            seed=SEED + 15).split("train")
    t0 = time.perf_counter()
    tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), attn_impl="fused", device="cuda")
    zoo_step_check(tr, cfg, tds.images[:eff], "ViT-Base/16-384")
    log(f"[long] (b) step 1 checks in {time.perf_counter() - t0:.1f} s")
    fwd = {KERNEL_NAME: 2 * 2 * a, "attention_fwd (S>256)": 2 * 2 * a * layers}
    split = {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers,
             "attention_bwd (S>256)": 2 * a * layers}
    merged = {"merged_bwd": 2 * a * layers, "attention_bwd (S>256)": 2 * a * layers}
    flash = {"flash_fwd": 2 * 2 * a * layers, "flash_bwd": 2 * a * layers,
             "flash_fwd (S>256)": 2 * 2 * a * layers, "flash_bwd (S>256)": 2 * a * layers}
    total = {}
    one = tds.subset(np.arange(eff))
    for impl, is_merged, images, per_step in (("fused", False, tds, {**fwd, **split}),
                                             ("fused", True, one, {**fwd, **merged}),
                                             ("pallas", False, one, flash)):
        use_path(tr, cfg, impl)
        trainer, n, _ = fit_path(cfg, images, impl, is_merged, per_step, trainer=tr)
        for k_, v_ in n.items():
            if k_.endswith("(S>256)"):
                total[k_] = total.get(k_, 0) + v_
        if not is_merged:  # the step's time by wrapper
            wrappers = ((KERNEL_NAME, "mlp_bwd", "attn_bwd") if impl == "fused"
                        else ("flash_fwd", "flash_bwd"))
            rest = ("views, embed, heads, loss, Adam, EMA" if impl == "fused" else
                    "views, embed, the per-op blocks' GEMMs and norms, heads, loss, Adam, EMA")
            totals = {}
            step_s = time_steps(trainer, eff, f"{impl} ViT-Base/16-384", card, wrappers, rest,
                                reps=2, totals=totals)
            device = totals.get("device", float("nan"))
            launches = sum(n for _, n in totals.get("kernels", {}).values())
            by = {w: totals.get(f"vit2spn::{w}", float("nan")) for w in wrappers}
            log(f"[long] (b) {impl} ViT-Base/16-384 step ({eff} images): wall "
                f"{1e3 * step_s:.2f} ms, {eff / step_s:.1f} img/s, device {device:.3f} ms "
                f"({', '.join(f'{w} {ms:.3f}' for w, ms in by.items())}, the rest "
                f"{device - sum(by.values()):.3f}) in {launches} launches, card idle "
                f"{100 * (1 - device / (1e3 * step_s)):.1f}% on {card}")
        os.environ["VIT2SPN_MERGED_BWD"] = "0"
    # extract through "fused" from the trained state, against the plain path
    ds = synthetic_dataset(split_sizes={"all": LONG_EXTRACT}, image_size=28, seed=SEED)
    use_path(tr, cfg, "fused")
    trainer.extract_features(ds, batch_size=LONG_EXTRACT_BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    feats, _ = trainer.extract_features(ds, batch_size=LONG_EXTRACT_BATCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k_: n for k_, n in read_launches().items() if n}
    calls = 2 * -(-LONG_EXTRACT // LONG_EXTRACT_BATCH)  # dual stream
    want = {KERNEL_NAME: calls, "attention_fwd (S>256)": calls * layers}
    totals = {}
    lines = stage_breakdown(lambda: trainer.extract_features(ds, batch_size=LONG_EXTRACT_BATCH),
                            f"ViT-Base/16-384 extract of {len(ds)} images", top=6,
                            wrappers=(KERNEL_NAME,), rest="views, embed, heads", totals=totals)
    trainer.attn_impl = "plain"
    plain, _ = trainer.extract_features(ds, batch_size=LONG_EXTRACT_BATCH)
    scale, err = float(np.abs(plain).max()), float(np.abs(feats - plain).max())
    log(f"[long] (b) ViT-Base/16-384 extract: {feats.shape} features in {secs:.3f} s, "
        f"{len(ds) / secs:.1f} img/s, launches {launches} (want {want}); forward device "
        f"{totals.get('vit2spn::' + KERNEL_NAME, float('nan')):.3f} ms of "
        f"{totals.get('device', float('nan')):.3f} ms; vs plain max_abs_err {err:.6g} (max "
        f"|plain| {scale:.4g}, tol {FEATURE_REL_TOL} relative) on {card}")
    for line in lines:
        log(line)
    if launches != want:
        raise AssertionError(f"ViT-Base/16-384 extract launched {launches}, not {want}")
    if feats.shape != (len(ds), cfg.proj_dim) or not np.isfinite(feats).all():
        raise AssertionError(f"ViT-Base/16-384 extract: bad features {feats.shape}")
    if not err <= FEATURE_REL_TOL * scale:
        raise AssertionError("ViT-Base/16-384 features disagree with the plain path")
    total["attention_fwd (S>256)"] += launches["attention_fwd (S>256)"]
    del trainer, tr
    gc.collect()
    torch.cuda.empty_cache()
    return total


def long_ft_run(card, extra=()) -> tuple:
    """Phase 15 (c) (and 16 (c), `extra` ["compute_dtype=float32"]): one
    `long_ft_runs` run. Returns (launches, the run's microbatch)."""
    return long_ft_runs(card, [extra])[0]


_FT_STAGED = []  # [(TemporaryDirectory, root)] once ft_stand_ins has staged them


def ft_stand_ins() -> str:
    """The root of phase 12's stand-ins (stage_folder_inputs, then `data
    merge-ucsd`) that every `run ft-ucsdoct` of phases 15, 16 and 19 reads:
    staged once a process in a temporary directory beside this script, or,
    in phase 19's child (`chip_smoke.py --general-long ROOT`), the root its
    parent staged."""
    import contextlib
    import io
    import tempfile

    from vit2spn_tpu_torch.cli import main as cli_main

    if sys.argv[1:2] == ["--general-long"] and len(sys.argv) > 2:
        return sys.argv[2]
    if not _FT_STAGED:
        tmp = tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__)))
        root = os.path.join(tmp.name, "datasets")
        t0 = time.perf_counter()
        stage_folder_inputs(root)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli_main(["data", "merge-ucsd", os.path.join(root, "ucsdoct")])
        if rc != 0:
            raise AssertionError(f"data merge-ucsd: rc {rc}")
        log(f"[long] the folder stand-ins for `run ft-ucsdoct` staged in "
            f"{time.perf_counter() - t0:.1f} s")
        _FT_STAGED.append((tmp, root))
    return _FT_STAGED[0][1]


def long_ft_runs(card, extras) -> list:
    """`run ft-ucsdoct` at 256 px sources and 256 px views (S = 257) on phase
    12's stand-ins (ft_stand_ins), one run for each tuple of `extras` with
    LONG_FT_OVERRIDES and those overrides, the counters read around each and
    held to the protocol's predicted launches (backbone, split halves and
    the long routes). Returns [(launches, the run's microbatch)] in
    `extras`' order."""
    import contextlib
    import io
    import tempfile

    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.cli import main as cli_main
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import load_dataset

    results = []
    root = ft_stand_ins()
    ucsd = load_dataset("ucsdoct", root=root, allow_synthetic=False)
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        for i, extra in enumerate(extras):
            over = [*LONG_FT_OVERRIDES, *extra, f"data.root={root}"]
            cfg = _apply_overrides(get_preset("ft-ucsdoct"), over)
            if (cfg.vit.seq_len, cfg.data.augment.out_size) != (257, 256):
                raise AssertionError(f"ft-ucsdoct at 256 px: S {cfg.vit.seq_len}")
            steps, evals, n_cv, n_test = protocol_launches(cfg, ucsd, 1)
            layers = cfg.vit.num_layers
            want = {**_wanted(steps, evals, layers),
                    "attention_fwd (S>256)": layers * (steps + evals),
                    "attention_bwd (S>256)": layers * steps}
            out = os.path.join(tmp, f"ft{i}")
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli_main(["run", "ft-ucsdoct", "--epochs", "1", "--output-dir", out,
                               *[x for o in over for x in ("-o", o)]])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = read_launches()
            with open(os.path.join(out, "metrics.jsonl")) as f:
                events = [json.loads(line) for line in f]
            aucs = [e["mauc"] for e in events if e["event"] == "fold_result"]
            log(f"[long] (c) run ft-ucsdoct at 256 px ({cfg.compute_dtype}, S=257, "
                f"{cfg.vit.num_heads} heads, {layers} layers; cut: 2 folds, 1 epoch, random init; "
                f"subset {n_cv}, "
                f"test {n_test}) in {secs:.1f} s: rc {rc}, {steps} train steps, {evals} eval "
                f"batches; fold mAUCs {aucs}; launches "
                f"{ {k_: n for k_, n in launches.items() if n} } (predicted {want}) on {card}")
            if rc != 0 or len(aucs) != 2 or not all(np.isfinite(aucs)):
                raise AssertionError(f"run ft-ucsdoct at 256 px: rc {rc}, fold mAUCs {aucs}")
            if launches != {k_: want.get(k_, 0) for k_ in launches}:
                raise AssertionError(f"run ft-ucsdoct at 256 px launched {launches}, predicted "
                                     f"{want}")
            results.append((launches, cfg.batch_size))
    return results


def long_bound_ms(kind, b, s, heads, fp32=False, dh=64) -> tuple:
    """Least time of one long-sequence route over b images x heads at S (bf16,
    or fp32, head_dim dh): its products (2 S^2 dh each per (image, head):
    the stage and the flash forward 2, the core and the flash backward 6 and
    5 as the function needs them) over the bf16 peak (the fp32 peak outside
    the tensor cores), vs its tensors read and written once (the stage: qkv
    in, att out; the core: qkv and datt in, att and dqkv out; flash as
    flash_bound_ms). Returns (ms, bound by, flops)."""
    if kind in ("flash_fwd", "flash_bwd"):
        return flash_bound_ms(kind.split("_")[1], b, s, heads, fp32, dh)
    products, rows = (2, 3 + 1) if kind == "attention_fwd" else (6, 3 + 1 + 1 + 3)
    d = dh * heads
    flops = b * heads * products * 2 * s * s * dh
    nbytes = rows * b * s * d * (4 if fp32 else 2)
    t_ops = flops / (PEAK_FP32_FLOPS if fp32 else PEAK_BF16_FLOPS)
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def long_times(fb, fa, card, dev, shapes, dtype=torch.bfloat16, dh=64) -> dict:
    """Phase 15 (d) (bf16) and 16 (d) (fp32), and 19 (d) at head_dim dh:
    each long route by launch at `shapes` ((label, B, S, heads): (b)'s and
    (c)'s attentions), CUDA events, beside its bound, its plain twin and
    SDPA in the same dtype (forward, or its autograd backward; a yardstick
    the port never calls; TF32 off), in bf16 the flash pair also beside SDPA
    on fp32 copies. Returns {route: {label: (ms, twin ms, library ms, bound
    ms, bound by, same-fn ms or None)}}."""
    fp32 = dtype == torch.float32
    stage, core = ((attention_stage_f32_call, attention_core_f32_call) if fp32
                   else (attention_stage_call, attention_core_call))
    out = {}
    for label, b, s, heads in shapes:
        d = dh * heads
        gen = torch.Generator().manual_seed(SEED + s)
        qkv = torch.randn(b, s, 3 * d, generator=gen).to(dtype).to(dev)
        datt = (0.1 * torch.randn(b, s, d, generator=gen)).to(dtype).to(dev)
        q, k, v = (t.reshape(b, s, heads, dh) for t in qkv.split(d, dim=-1))
        do = datt.reshape(b, s, heads, dh)
        sdpa_in = [t.transpose(1, 2) for t in (q, k, v)]
        sdpa_bwd, _ = library_flash_bwd(q, k, v, do)
        same = {}
        if not fp32:
            same_fwd, same_bwd = check_same_fn_yardstick(q, k, v, do)
            with torch.no_grad():
                same["flash_fwd"] = time_ms(same_fwd, iters=10, warmup=2)
            same["flash_bwd"] = time_ms(same_bwd, iters=10, warmup=2)
            del same_fwd, same_bwd
        routes = (
            ("attention_fwd", lambda: stage(fb, qkv, heads),
             lambda: attention_stage_plain(qkv, heads),
             lambda: F.scaled_dot_product_attention(*sdpa_in)),
            ("attention_bwd", lambda: core(fb, qkv, datt, heads),
             lambda: fb._attention_bwd(qkv, datt, heads), sdpa_bwd),
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
             lambda: F.scaled_dot_product_attention(*sdpa_in)),
            ("flash_bwd", lambda: fa.flash_bwd(q, k, v, do),
             lambda: fa.flash_attention_bwd_plain(q, k, v, do), sdpa_bwd),
        )
        sdpa = f"{'fp32' if fp32 else 'bf16'} SDPA"
        for route, kernel, twin, library in routes:
            k_ms = time_ms(kernel, iters=10, warmup=2)
            p_ms = time_ms(twin, iters=3, warmup=1)
            with torch.no_grad() if route.endswith("fwd") else torch.enable_grad():
                l_ms = time_ms(library, iters=10, warmup=2)
            b_ms, b_by, flops = long_bound_ms(route, b, s, heads, fp32, dh)
            out.setdefault(route, {})[label] = (k_ms, p_ms, l_ms, b_ms, b_by, same.get(route))
            same_txt = (f", SDPA{' backward' if route.endswith('bwd') else ''} on fp32 copies "
                        f"(same fn) {same[route]:.4f} ms" if route in same else "")
            log(f"[time] {route} ({'fp32, ' if fp32 else ''}S>256) {label} B={b} S={s} "
                f"heads={heads} head_dim {dh}: kernel {k_ms:.4f} ms per launch, plain twin {p_ms:.3f} ms, "
                f"{sdpa}{' backward' if route.endswith('bwd') else ''} {l_ms:.4f} ms{same_txt}, "
                f"bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP), kernel at "
                f"{flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, {100 * b_ms / k_ms:.1f}% of the "
                f"bound; {card}")
        del qkv, datt, q, k, v, do, sdpa_in, sdpa_bwd
        torch.cuda.empty_cache()
    return out


# the four long routes: (route, source, the Pallas kernel whose attention it
# computes above 256 keys)
LONG_ROUTES = (
    ("attention_fwd", "vit2spn_tpu/ops/fused_block.py:694"),
    ("attention_bwd", "vit2spn_tpu/ops/fused_block.py:357"),
    ("flash_fwd", "vit2spn_tpu/ops/flash_attention.py:36"),
    ("flash_bwd", "vit2spn_tpu/ops/flash_attention.py:53"),
)


def long_entries(times, launches, ft_launches, errs, fp32=False) -> list:
    """The `kernels` entries of the four long routes (phase 15, or with
    `fp32` phase 16's fp32 routes): launches from (b), ft_256px_launches
    from (c), times at (b)'s attention and (c)'s in `at_256px`."""
    entries = []
    for route, replaces in LONG_ROUTES:
        counter, name = f"{route} (S>256)", f"{route} ({'fp32, ' if fp32 else ''}S>256)"
        k_ms, p_ms, l_ms, b_ms, b_by, same_ms = times[route]["ViT-Base/16-384"]
        entries.append({
            "name": name, "route": "cuda",
            "source": ("vit2spn_tpu_torch/csrc/flash_f32.cuh" if fp32
                       else "vit2spn_tpu_torch/csrc/long_attention.cuh"),
            "replaces": replaces, "launches": launches.get(counter, 0),
            "ft_256px_launches": ft_launches.get(counter, 0), "max_abs_err": errs[route],
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms, "dtype": "float32" if fp32 else "bfloat16",
            "shape": f"B={LONG_MICRO} S=577 heads=12 (ViT-Base/16-384)",
            "at_256px": {k_: v_ for k_, v_ in zip(
                ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "same_fn_library_ms"),
                times[route]["ViT-Tiny 256 px"]) if v_ is not None},
        })
        if same_ms is not None:
            entries[-1]["same_fn_library_ms"] = same_ms
        if not entries[-1]["launches"]:
            raise AssertionError(f"{name} was never launched on its phase's main path")
    return entries


def long_seq_path(fb, fa, card, dev) -> list:
    """Phase 15: (a) the kernels against their twins and the wrappers'
    calls, (b) ViT-Base/16-384 training and extract, (c) `run ft-ucsdoct` at
    256 px, (d) the times. Returns the four routes' `kernels` entries."""
    t_phase = time.perf_counter()
    errs = long_kernels(fb, fa, dev)
    long_calls(fb, fa, dev)
    long_limits(fb, dev)
    log(f"[long] (a) in {time.perf_counter() - t_phase:.1f} s: largest absolute differences "
        f"from the twins {errs}")
    t0 = time.perf_counter()
    launches = long_training(card)
    log(f"[long] (b) in {time.perf_counter() - t0:.1f} s: long-route launches {launches}")
    t0 = time.perf_counter()
    ft_launches, ft_batch = long_ft_run(card)
    log(f"[long] (c) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = long_times(fb, fa, card, dev, (("ViT-Base/16-384", LONG_MICRO, 577, 12),
                                           ("ViT-Tiny 256 px", ft_batch, 257, 3)))
    log(f"[long] (d) in {time.perf_counter() - t0:.1f} s; phase 15 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return long_entries(times, launches, ft_launches, errs)


# Phase 16: fp32 above 256 tokens (compute_dtype=float32), the multi-pass
# route of csrc/flash_f32.cuh behind every fp32 attention on the card: the
# forward layer's attention stage, the backward's attention core (the
# forward for att, then the two-launch backward), the flash forward and
# backward. (a) holds each against its fp32 twin (FP32_TOL of each output's
# largest magnitude; the flash pair check_flash's fp32 tolerances) and
# against the same twin run in float64 (as close as the fp32 twin: the mean
# error at most KERNEL_VS_FP32_RATIO times the twin's plus FP32_VS_FP64_SLACK;
# the flash pair within FLASH_FP32_VS_FP64_TOL) at LONG_SEQS and LONG_WIDTHS,
# with phase 15's bit checks; and the four one-layer kernels' fp32 routes
# and a 2-layer fp32 fused_backbone through the wrappers the same way. Up to
# FP32_ONEPASS_MAX_S keys the routes run flash_f32.cuh's one-pass kernels,
# which form the multi-pass route's p bit for bit and sum the products with
# p and dS in another order: at FP32_ONEPASS_SEQS the stage and the core are
# held against the multi-pass route (forced through the C entries'
# `multipass` argument) and float64 (check_onepass_vs_multipass); and the
# multi-pass route, which takes S above it, is held at FP32_MULTIPASS_SEQ
# the same way as the LONG_SEQS (twins, float64, bits).
FP32_ONEPASS_MAX_S = 1152  # flash_f32.cuh OP_MAX_S
FP32_ONEPASS_SEQS = (577, 1024)
FP32_MULTIPASS_SEQ = (1200, 1)  # (S, B), at LONG_WIDTHS[0]


def attention_stage_f32_call(fb, qkv, heads, multipass=False):
    """The fp32 forward layer's attention stage alone (csrc/layer_fwd.cu
    vit2spn_attention_stage_f32): att (B, S, D) from an fp32 qkv (B, S, 3D);
    `multipass` forces the multi-pass route above 256 keys."""
    b, s, d3 = qkv.shape
    att = torch.empty((b, s, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    lib = fb._load("layer_fwd")
    fb._raise_on(lib, lib.vit2spn_attention_stage_f32(qkv.data_ptr(), att.data_ptr(), b, s,
                                                      heads, d3 // 3, int(multipass),
                                                      fb._stream(qkv.device)),
                 "fp32 attention stage")
    return att


def attention_core_f32_call(fb, qkv, datt, heads, multipass=False):
    """The fp32 backward's attention core alone (csrc/attn_bwd.cu
    vit2spn_attention_core_f32): (att, dqkv) from qkv and datt; `multipass`
    forces the multi-pass route above 256 keys."""
    b, s, d3 = qkv.shape
    att = torch.empty_like(datt)
    dqkv = torch.empty_like(qkv)
    ws = torch.empty(b * heads * s * 3, dtype=torch.float32, device=qkv.device)
    lib = fb._load("attn_bwd")
    fb._raise_on(lib, lib.vit2spn_attention_core_f32(
        qkv.data_ptr(), datt.data_ptr(), att.data_ptr(), dqkv.data_ptr(), ws.data_ptr(), b, s,
        heads, d3 // 3, int(multipass), fb._stream(qkv.device)), "fp32 attention core")
    return att, dqkv


def check_fp32_core_pair(fb, tag, qkv, datt, heads, errs):
    """Phase 16 (a) at one shape: the fp32 stage and core against their
    twins and float64 (into `errs`), the core's att equal to the stage's and
    two core runs equal bit for bit. Returns (stage att, core (att, dqkv))."""
    d = qkv.shape[-1] // 3
    thirds = lambda t: (t[0], *t[1].split(d, dim=-1))  # noqa: E731
    att_f = attention_stage_f32_call(fb, qkv, heads)
    core = attention_core_f32_call(fb, qkv, datt, heads)
    torch.cuda.synchronize()
    errs["attention_fwd"] = max(errs["attention_fwd"], check_fp32_outputs(
        "attention-stage-fp32", tag, ("att",), (att_f,), (attention_stage_plain(qkv, heads),),
        (attention_stage_plain(qkv.double(), heads),), FP32_TOL))
    errs["attention_bwd"] = max(errs["attention_bwd"], check_fp32_outputs(
        "attention-core-fp32", tag, ("att", "dq", "dk", "dv"), thirds(core),
        thirds(fb._attention_bwd(qkv, datt, heads)),
        thirds(fb._attention_bwd(qkv.double(), datt.double(), heads)), FP32_TOL))
    again = attention_core_f32_call(fb, qkv, datt, heads)
    torch.cuda.synchronize()
    same_att = torch.equal(core[0], att_f)
    same = torch.equal(again[0], core[0]) and torch.equal(again[1], core[1])
    log(f"[long-bits] {tag}: core att = stage att bit for bit {same_att}; two core "
        f"runs equal {same}")
    if not (same_att and same):
        raise AssertionError(f"fp32 long attention bits ({tag}): att {same_att}, runs "
                             f"{same}")
    return att_f, core


def check_onepass_vs_multipass(fb, tag, qkv, datt, heads, att_f, core):
    """The one-pass route's stage att and core (att, dq, dk, dv) against the
    multi-pass route's on the same inputs. Both form the same p; the one-pass
    route sums its products with p and dS in split runs (flash_f32.cuh), the
    multi-pass route per 256-key chunk, so they differ by fp32
    reassociation: within FP32_TOL of each other, and the one-pass route as
    close to float64 as the multi-pass route (check_fp32_outputs, which logs
    the ratio of their mean errors against float64)."""
    d = qkv.shape[-1] // 3
    thirds = lambda t: (t[0], *t[1].split(d, dim=-1))  # noqa: E731
    multi_att = attention_stage_f32_call(fb, qkv, heads, multipass=True)
    multi = attention_core_f32_call(fb, qkv, datt, heads, multipass=True)
    torch.cuda.synchronize()
    ref64 = thirds(fb._attention_bwd(qkv.double(), datt.double(), heads))
    check_fp32_outputs("one-pass-vs-multi-pass", tag, ("stage att", "att", "dq", "dk", "dv"),
                       (att_f, *thirds(core)), (multi_att, *thirds(multi)),
                       (ref64[0], *ref64), FP32_TOL)


def fp32_long_kernels(fb, fa, dev) -> dict:
    """Phase 16 (a). Returns each route's largest absolute difference from
    its fp32 twin: {"attention_fwd", "attention_bwd", "flash_fwd",
    "flash_bwd"}."""
    eps = 1e-12
    errs = {"attention_fwd": 0.0, "attention_bwd": 0.0, "flash_fwd": 0.0, "flash_bwd": 0.0}
    for label, d, heads, mlp in LONG_WIDTHS:
        gen = torch.Generator().manual_seed(SEED + 16 + d)
        for s, b in LONG_SEQS:
            tag = f"fp32 {label} heads={heads} S={s} B={b}"
            # the stage and the core alone
            qkv = torch.randn(b, s, 3 * d, generator=gen).to(dev)
            datt = (0.1 * torch.randn(b, s, d, generator=gen)).to(dev)
            att_f, core = check_fp32_core_pair(fb, tag, qkv, datt, heads, errs)
            if s in FP32_ONEPASS_SEQS:
                check_onepass_vs_multipass(fb, tag, qkv, datt, heads, att_f, core)
            del qkv, datt, att_f, core
            # the flash pair
            for k_, v_ in check_flash(f"long {tag}", *flash_operands(
                    gen, b, s, heads, torch.float32, dev)).items():
                errs[k_] = max(errs[k_], v_)
            ops = flash_operands(torch.Generator().manual_seed(SEED + s), b, s, heads,
                                 torch.float32, dev)
            runs = [fa.flash_bwd(*ops) for _ in range(2)]
            torch.cuda.synchronize()
            if not all(torch.equal(x_, y_) for x_, y_ in zip(*runs)):
                raise AssertionError(f"the fp32 flash backward is not deterministic ({tag})")
            del ops, runs
            # the layers through the wrappers
            wt = tuple(t.float() for t in random_backbone(gen, LONG_LAYERS, d, mlp, dev))
            x = torch.randn(b, s, d, generator=gen).to(dev)
            check_fp32_outputs(
                "fused_backbone-fp32", f"{tag} L={LONG_LAYERS}", ("out",),
                (fb.fused_backbone(x, wt, heads, eps, True),),
                (fb.backbone_forward_plain(x, wt, heads, eps, True),),
                (fb.backbone_forward_plain(x.double(), tuple(t.double() for t in wt), heads,
                                           eps, True),), FP32_TOL)
            w = layer_weights(fb.WEIGHT_NAMES, tuple(t[:1] for t in wt))
            x2 = torch.randn(b, s, d, generator=gen).to(dev)
            g = (0.1 * torch.randn(b, s, d, generator=gen)).to(dev)
            check_fp32_layer(tag, fb, x, x2, g, w, heads, eps, True)
            for name, fn in (("attn_bwd", lambda: fb.attn_bwd(x, g, w, heads, eps)),
                             ("merged_bwd", lambda: fb.merged_bwd(x, x2, g, w, heads, eps,
                                                                  True))):
                runs = [tensors_of(fn()) for _ in range(2)]
                torch.cuda.synchronize()
                same = all(torch.equal(a_, b_) for a_, b_ in zip(*runs))
                log(f"[long-bits] {tag}: two {name} runs equal bit for bit {same}")
                if not same:
                    raise AssertionError(f"fp32 {name} is not deterministic ({tag})")
                del runs
            check_merged_bwd(tag, fb, x, x2, g, w, heads, eps, True, True)
            del wt, x, x2, g, w
            torch.cuda.empty_cache()
    # the multi-pass route above the one-pass route's S
    (s, b), (label, d, heads, _) = FP32_MULTIPASS_SEQ, LONG_WIDTHS[0]
    if s <= FP32_ONEPASS_MAX_S:
        raise AssertionError(f"S = {s} does not reach the multi-pass route")
    tag = f"fp32 multi-pass {label} heads={heads} S={s} B={b}"
    gen = torch.Generator().manual_seed(SEED + 16 + s)
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(dev)
    datt = (0.1 * torch.randn(b, s, d, generator=gen)).to(dev)
    check_fp32_core_pair(fb, tag, qkv, datt, heads, errs)
    for k_, v_ in check_flash(f"long {tag}", *flash_operands(
            gen, b, s, heads, torch.float32, dev)).items():
        errs[k_] = max(errs[k_], v_)
    return errs


def fp32_long_training(card) -> dict:
    """Phase 16 (b): ViT-Base/16-384 under compute_dtype=float32 (phase 15
    (b)'s overrides and 2 x 64 cut): step 1 of "fused" against "xla" from one
    state (compare_steps), then `fit` of one merged and one split "fused"
    step and one "pallas" step (the flash pair) on one trainer with every
    counter as predicted, and the split step's device time by wrapper.
    Returns the long-sequence routes' launches summed over the three fits."""
    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    cfg = _apply_overrides(get_preset("ssp-scratch"), [
        *LONG_OVERRIDES, "compute_dtype=float32", f"batch_size={LONG_MICRO}",
        f"accumulation_steps={LONG_ACCUM}", f"vit.num_layers={LONG_TRAIN_LAYERS}"])
    vit = cfg.vit
    geom = (vit.image_size, vit.hidden_size, vit.num_heads, vit.mlp_dim, vit.num_layers,
            vit.seq_len, cfg.compute_dtype)
    if geom != (384, 768, 12, 3072, LONG_TRAIN_LAYERS, 577, "float32"):
        raise AssertionError(f"the fp32 ViT-Base/16-384 overrides gave {geom}")
    eff, a, layers = cfg.effective_batch, cfg.accumulation_steps, vit.num_layers
    log(f"[fp32-long] (b) ViT-Base/16-384 SSP: S={vit.seq_len}, D={vit.hidden_size}, "
        f"{a} x {cfg.batch_size} (cut from 8 x 128), {layers} layers (cut from 12), fp32")
    tds = synthetic_dataset(split_sizes={"train": eff}, image_size=28,
                            seed=SEED + 16).split("train")
    t0 = time.perf_counter()
    step_check(_apply_overrides(cfg, ["vit.remat=full"]), tds.images[:eff], cfg.learning_rate,
               ref=("xla", False))
    log(f"[fp32-long] (b) step 1 against xla in {time.perf_counter() - t0:.1f} s")
    tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), device="cuda")
    fwd = {KERNEL_NAME: 2 * 2 * a, "attention_fwd (S>256)": 2 * 2 * a * layers}
    split = {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers,
             "attention_bwd (S>256)": 2 * a * layers}
    merged = {"merged_bwd": 2 * a * layers, "attention_bwd (S>256)": 2 * a * layers}
    flash = {"flash_fwd": 2 * 2 * a * layers, "flash_bwd": 2 * a * layers,
             "flash_fwd (S>256)": 2 * 2 * a * layers, "flash_bwd (S>256)": 2 * a * layers}
    total = {}
    for impl, is_merged, per_step in (("fused", True, {**fwd, **merged}),
                                      ("fused", False, {**fwd, **split}),
                                      ("pallas", False, flash)):
        use_path(tr, cfg, impl)
        trainer, n, _ = fit_path(cfg, tds, impl, is_merged, per_step, trainer=tr)
        for k_, v_ in n.items():
            if k_.endswith("(S>256)"):
                total[k_] = total.get(k_, 0) + v_
        os.environ["VIT2SPN_MERGED_BWD"] = "0"
        if impl == "fused" and not is_merged:  # the step's time by wrapper
            wrappers = (KERNEL_NAME, "mlp_bwd", "attn_bwd")
            totals = {}
            step_s = time_steps(trainer, eff, "fused fp32 ViT-Base/16-384", card, wrappers,
                                "views, embed, heads, loss, Adam, EMA", reps=1, totals=totals)
            device = totals.get("device", float("nan"))
            by = {w: totals.get(f"vit2spn::{w}", float("nan")) for w in wrappers}
            log(f"[fp32-long] (b) fused fp32 ViT-Base/16-384 step ({eff} images): wall "
                f"{1e3 * step_s:.2f} ms, {eff / step_s:.1f} img/s, device {device:.3f} ms "
                f"({', '.join(f'{w} {ms:.3f}' for w, ms in by.items())}, the rest "
                f"{device - sum(by.values()):.3f}), card idle "
                f"{100 * (1 - device / (1e3 * step_s)):.1f}% on {card}")
    del tr, trainer
    gc.collect()
    torch.cuda.empty_cache()
    return total


def multipass_times(fb, card, dev, shapes, times):
    """Phase 16 (d): the fp32 stage and core forced onto the multi-pass
    route (the C entries' `multipass`) at `shapes`, CUDA events, beside the
    one-pass route's times in `times` (long_times)."""
    for label, b, s, heads in shapes:
        d = 64 * heads
        gen = torch.Generator().manual_seed(SEED + s)
        qkv = torch.randn(b, s, 3 * d, generator=gen).to(dev)
        datt = (0.1 * torch.randn(b, s, d, generator=gen)).to(dev)
        stage_ms = time_ms(lambda: attention_stage_f32_call(fb, qkv, heads, True), iters=5,
                           warmup=1)
        core_ms = time_ms(lambda: attention_core_f32_call(fb, qkv, datt, heads, True), iters=5,
                          warmup=1)
        log(f"[time] fp32 multi-pass route (forced), {label} B={b} S={s} heads={heads}: stage "
            f"{stage_ms:.4f} ms, core {core_ms:.4f} ms; the route taken (one-pass up to S = "
            f"{FP32_ONEPASS_MAX_S}) {times['attention_fwd'][label][0]:.4f} and "
            f"{times['attention_bwd'][label][0]:.4f} ms; {card}")
        del qkv, datt
    torch.cuda.empty_cache()


def fp32_long_path(fb, fa, card, dev) -> list:
    """Phase 16: (a) the fp32 routes against their twins and float64, and
    the wrappers' calls at S = 577; (b) fp32 ViT-Base/16-384 training; (c)
    `run ft-ucsdoct -o compute_dtype=float32` at 256 px and the parity
    runbook's path at both lengths; (d) the times. Returns the four fp32
    routes' `kernels` entries."""
    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.evals.parity import runbook_attn_impl

    t_phase = time.perf_counter()
    errs = fp32_long_kernels(fb, fa, dev)
    long_calls(fb, fa, dev, torch.float32)
    log(f"[fp32-long] (a) in {time.perf_counter() - t_phase:.1f} s: largest absolute "
        f"differences from the fp32 twins {errs}")
    t0 = time.perf_counter()
    launches = fp32_long_training(card)
    log(f"[fp32-long] (b) in {time.perf_counter() - t0:.1f} s: long-route launches {launches}")
    t0 = time.perf_counter()
    ft_launches, ft_batch = long_ft_run(card, ("compute_dtype=float32",))
    paths = {}
    for preset, over in (("ssp-scratch", LONG_OVERRIDES), ("ft-ucsdoct", LONG_FT_OVERRIDES)):
        vit = _apply_overrides(get_preset(preset), [*over, "compute_dtype=float32"]).vit
        paths[vit.seq_len] = runbook_attn_impl(vit, dev, "float32")
    log(f"[fp32-long] (c) in {time.perf_counter() - t0:.1f} s; the parity runbook's path in "
        f"fp32 on {dev} by S: {paths}")
    if paths != {577: "fused", 257: "fused"}:
        raise AssertionError(f"the runbook does not keep the kernels for fp32 above 256: {paths}")
    t0 = time.perf_counter()
    shapes = (("ViT-Base/16-384", LONG_MICRO, 577, 12), ("ViT-Tiny 256 px", ft_batch, 257, 3))
    times = long_times(fb, fa, card, dev, shapes, torch.float32)
    multipass_times(fb, card, dev, shapes, times)
    log(f"[fp32-long] (d) in {time.perf_counter() - t0:.1f} s; phase 16 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    return long_entries(times, launches, ft_launches, errs, fp32=True)


# Phase 17: head_dim 16, 32 and 48, and D below 64: the general route of
# every kernel (ops/fused_block.py geometry_route, csrc/common.cuh
# general_route): the seven-launch forward layer in bf16 and fp32, the
# backward halves' sequences, the S <= 256 attention kernels instantiated on
# the head_dim. (a) At HD_GEOMS and HD_SHAPES (ragged B, S = 5 / 50 / 197 /
# 256) and at the main path's own B and S (HD_MAIN_SHAPES: 128 x 5 at D 32,
# 128 x 197 at D 192), bf16 and fp32: a 2-layer fused_backbone (with and without the
# emit_res stacks), layer_fwd, mlp_bwd, attn_bwd, merged_bwd (equal to the
# split pair bit for bit) and the flash pair, each against its plain twin
# (bf16: BWD_*_REL_TOL of the twin's largest magnitude, and as close to the
# fp32 function as the twin where B S >= 100; fp32: FP32_TOL and float64, as
# phase 7b; the flash pair as phase 5), every wrapper's counter raised by
# one a call. (b) Each route's CUDA launches (the C entries' counts) against
# the prediction of hd_predicted_launches, and in a fresh process (`--hd-trace`)
# the device kernels a trace of STAGE_CALLS calls holds: exactly the route's
# kernels, STAGE_CALLS times the prediction. (c) Two runs of each backward
# equal bit for bit. (d) The main path: the tiny model (HD_TINY: D 32, 2
# heads, mlp 64, 2 layers, 32 px) and ViT-Tiny's width at 6 and 4 heads on
# the card through "fused": step 1 against "xla" (bf16, with the fp32 step
# at the tiny model) and in fp32; `fit` through
# "fused", "fused" merged, "fused_layer" and "pallas" with every counter as
# predicted; `run ssp-scratch` at the tiny model in bf16 and fp32, `extract`
# and `run ft-octmnist` from its export, and `parity --smoke`, which now
# takes "fused" and records it. (e) The times at ViT-Tiny's width (D 192,
# B = 128, S = 197) for each head_dim beside the head_dim-64 route and the
# library call. `python3 chip_smoke.py --head-dim` runs the build and this
# phase alone.
HD_GEOMS = (("hd16 D=32", 32, 2, 64), ("hd32 D=64", 64, 2, 128), ("hd48 D=96", 96, 2, 384),
            ("hd16 D=192", 192, 12, 768), ("hd32 D=192", 192, 6, 768),
            ("hd48 D=192", 192, 4, 768))
HD_SHAPES = ((3, 5), (2, 50), (5, 197), (2, 256))  # (B, S)
# ... and, by D, the (B, S) the main path (d) gives the kernels there: the
# tiny model's microbatch of 128 at S = 5, ViT-Tiny's of 128 at S = 197 (its
# GEMMs' M = 25,216: the masked column tiles and the weight-gradient splits
# at the main path's M)
HD_MAIN_SHAPES = {32: ((128, 5),), 192: ((128, 197),)}
HD_DIMS = (16, 32, 48)
HD_TIME_B, HD_TIME_S, HD_TIME_D, HD_TIME_MLP = 128, 197, 192, 768
HD_TIME_HEADS = ((16, 12), (32, 6), (48, 4), (64, 3))  # (head_dim, heads) at D 192
HD_TINY = ("vit.image_size=32", "vit.hidden_size=32", "vit.num_layers=2", "vit.num_heads=2",
           "vit.mlp_dim=64", "data.augment.out_size=32")
HD_TINY_SPLITS = {"train": 512, "val": 64, "test": 128}  # (d): two SSP steps of 2 x 128
HD_KERNELS = (("backbone_fwd", "backbone_fwd.cu", "vit2spn_tpu/ops/fused_block.py:694"),
              ("layer_fwd", "layer_fwd.cu", "vit2spn_tpu/ops/fused_block.py:170"),
              ("mlp_bwd", "mlp_bwd.cu", "vit2spn_tpu/ops/fused_block.py:342"),
              ("attn_bwd", "attn_bwd.cu", "vit2spn_tpu/ops/fused_block.py:357"),
              ("merged_bwd", "merged_bwd.cu", "vit2spn_tpu/ops/fused_block.py:375"),
              ("flash_fwd", "flash_attention.cu", "vit2spn_tpu/ops/flash_attention.py:36"),
              ("flash_bwd", "flash_attention.cu", "vit2spn_tpu/ops/flash_attention.py:53"))


def hd_predicted_launches(name, d, heads, mlp, fp32) -> int:
    """CUDA launches of one wrapper call (a forward: per layer) as the
    routes are written: the forward's 3-launch fused layer at head_dim 64, D
    and mlp multiples of 64, D <= 256, else 7; the backward halves' kit (5
    and 6, the wide route 7 and 7) at bf16, D and mlp multiples of 64 and
    head_dim 64 (the MLP half: any head_dim), else the sequences (10, and 11
    in bf16 or 13 in fp32); merged the kit's 10 / 13, else its halves' in a
    row; the flash pair 1 and 2."""
    kit = not fp32 and d % 64 == 0 and (d <= 256 or d in (384, 768))
    kit_mlp, kit_attn = kit and mlp % 64 == 0, kit and d == 64 * heads
    general = d % 64 or mlp % 64 or d != 64 * heads
    n_mlp = (7 if d > 256 else 5) if kit_mlp else 10
    n_attn = (7 if d > 256 else 6) if kit_attn else (13 if fp32 else 11)
    return {"backbone_fwd": 7 if fp32 or general or d > 256 else 3,
            "layer_fwd": 7 if fp32 or general or d > 256 else 3,
            "mlp_bwd": n_mlp, "attn_bwd": n_attn,
            "merged_bwd": ((13 if d > 256 else 10) if kit_mlp and kit_attn
                           else n_mlp + n_attn),
            "flash_fwd": 1, "flash_bwd": 2}[name]


def hd_operands(gen, b, s, d, heads, dtype, dev):
    """x, x2, an output gradient (B, S, D) and flash operands (views of one
    (B, S, 3D) qkv and dO, head_dim D / heads) in `dtype`."""
    dh = d // heads
    x, x2 = (torch.randn(b, s, d, generator=gen) for _ in range(2))
    g = 0.1 * torch.randn(b, s, d, generator=gen)
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(dtype).to(dev)
    q, k, v = (t.reshape(b, s, heads, dh) for t in qkv.split(d, dim=-1))
    do = (0.1 * torch.randn(b, s, heads, dh, generator=gen)).to(dtype).to(dev)
    return (*(t.to(dtype).to(dev) for t in (x, x2, g)), q, k, v, do)


def hd_counted(fb, name, fn):
    """fn() with the wrapper `name`'s counter checked to rise by one."""
    wrapper = kernel_counters()[name]
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    if wrapper.launches != before + 1:
        raise AssertionError(f"{name} did not count its launch ({wrapper.launches - before})")
    return out


def hd_flat(out, names):
    return [out[0], *[out[1][n] for n in names]]


def hd_kernels(fb, fa, dev, geoms=HD_GEOMS, shapes=HD_SHAPES, main_shapes=HD_MAIN_SHAPES,
               seed=SEED + 17) -> dict:
    """Phase 17 (a) (and 19 (a) with phase 19's geometries and shapes).
    Returns {(kernel, head_dim, dtype): largest absolute difference from the
    twin}."""
    eps, errs = 1e-12, {}

    def note(name, dh, dt, e):
        key = (name, dh, dt)
        errs[key] = max(errs.get(key, 0.0), e)

    for label, d, heads, mlp in geoms:
        dh = d // heads
        gen = torch.Generator().manual_seed(seed + d + heads)
        wt = random_backbone(gen, 2, d, mlp, dev)
        wt32 = tuple(t.float() for t in wt)
        w = layer_weights(fb.WEIGHT_NAMES, wt)
        w32 = {n: t.float() for n, t in w.items()}
        w0 = tuple(t[0] for t in wt)
        for b, s in shapes + main_shapes.get((d, heads), main_shapes.get(d, ())):
            fast = s % 2 == 1
            tag = f"{label} heads={heads} mlp={mlp} B={b} S={s} fast_gelu={fast}"
            x, x2, g, q, k, v, do = hd_operands(gen, b, s, d, heads, torch.bfloat16, dev)
            vs32 = b * s >= 100
            # bf16: the forwards, the halves, merged (equal to the split pair), flash
            for emit in (False, True):
                got = hd_counted(fb, "backbone_fwd",
                                 lambda: fb.fused_backbone(x, wt, heads, eps, fast, emit))
                ref = fb.backbone_forward_plain(x, wt, heads, eps, fast, emit)
                ref32 = fb.backbone_forward_plain(x.float(), wt32, heads, eps, fast, emit)
                got, ref, ref32 = ((got, ref, ref32) if emit else ((got,), (ref,), (ref32,)))
                note("backbone_fwd", dh, "bf16", check_rel(
                    f"{tag} emit_res={emit}", ("out", "xs", "x2s")[:len(got)], got, ref,
                    ref32 if vs32 else None, "hd-backbone_fwd"))
            got = hd_counted(fb, "layer_fwd", lambda: fb.layer_fwd(x, w0, heads, eps, fast))
            note("layer_fwd", dh, "bf16", check_rel(
                tag, ("out", "x2"), got, fb.layer_forward_plain(x, w0, heads, eps, fast),
                fb.layer_forward_plain(x.float(), tuple(t[0] for t in wt32), heads, eps, fast)
                if vs32 else None, "hd-layer_fwd"))
            for name, names, kernel, twin, fp32 in (
                    ("mlp_bwd", ("dx2",) + fb.MLP_NAMES,
                     lambda: fb.mlp_bwd(x2, g, w, eps, fast),
                     lambda: fb.mlp_bwd_plain(x2, g, w, eps, fast),
                     lambda: fb.mlp_bwd_plain(x2.float(), g.float(), w32, eps, fast)),
                    ("attn_bwd", ("dx",) + fb.ATTN_NAMES,
                     lambda: fb.attn_bwd(x, g, w, heads, eps),
                     lambda: fb.attn_bwd_plain(x, g, w, heads, eps),
                     lambda: fb.attn_bwd_plain(x.float(), g.float(), w32, heads, eps))):
                got = hd_flat(hd_counted(fb, name, kernel), names[1:])
                note(name, dh, "bf16", check_rel(
                    tag, names, got, hd_flat(twin(), names[1:]),
                    hd_flat(fp32(), names[1:]) if vs32 else None, f"hd-{name}"))
            merged = hd_counted(fb, "merged_bwd",
                                lambda: fb.merged_bwd(x, x2, g, w, heads, eps, fast))
            dx2, mg = fb.mlp_bwd(x2, g, w, eps, fast)
            sdx, sg = fb.attn_bwd(x, dx2, w, heads, eps)
            split = [sdx, *[{**mg, **sg}[n] for n in fb.WEIGHT_NAMES]]
            got = hd_flat(merged, fb.WEIGHT_NAMES)
            share = min(equal_bits(a, b_) for a, b_ in zip(got, split))
            if share != 1.0:
                raise AssertionError(f"merged_bwd differs from the split pair bit for bit ({tag})")
            note("merged_bwd", dh, "bf16", check_rel(
                f"{tag} (equal bits with the split pair)", ("dx",) + fb.WEIGHT_NAMES, got,
                hd_flat(fb.merged_bwd_plain(x, x2, g, w, heads, eps, fast), fb.WEIGHT_NAMES),
                hd_flat(fb.merged_bwd_plain(x.float(), x2.float(), g.float(), w32, heads, eps,
                                            fast), fb.WEIGHT_NAMES) if vs32 else None,
                "hd-merged_bwd"))
            before = (fa.flash_fwd.launches, fa.flash_bwd.launches)
            fl = check_flash(f"{tag} bf16", q, k, v, do)
            if (fa.flash_fwd.launches, fa.flash_bwd.launches) != (before[0] + 1, before[1] + 1):
                raise AssertionError(f"the flash pair did not count its launches ({tag})")
            note("flash_fwd", dh, "bf16", fl["flash_fwd"])
            note("flash_bwd", dh, "bf16", fl["flash_bwd"])
            # fp32: the four one-layer kernels (check_fp32_layer counts
            # them), the 2-layer backbone, the flash pair
            for n_, e in check_fp32_layer(tag, fb, x.float(), x2.float(), g.float(), w, heads,
                                          eps, fast).items():
                note(n_, dh, "fp32", e)
            x32 = x.float()
            got = hd_counted(fb, "backbone_fwd",
                             lambda: fb.fused_backbone(x32, wt32, heads, eps, fast))
            note("backbone_fwd", dh, "fp32", check_fp32_outputs(
                "backbone_fwd-fp32", tag, ("out",), [got],
                [fb.backbone_forward_plain(x32, wt32, heads, eps, fast)],
                [fb.backbone_forward_plain(x.double(), tuple(t.double() for t in wt), heads,
                                           eps, fast)], FP32_TOL))
            fl = check_flash(f"{tag} fp32", *(t.float() for t in (q, k, v, do)))
            note("flash_fwd", dh, "fp32", fl["flash_fwd"])
            note("flash_bwd", dh, "fp32", fl["flash_bwd"])
        del wt, wt32, w, w32
        torch.cuda.empty_cache()
    return errs


# The kernels each wrapper's route runs at ViT-Tiny's width with 6 heads
# (head_dim 32: the general route, whose MLP half keeps the bf16 kit at D
# 192), by (wrapper, fp32)
HD_SEQ_BWD = {"layernorm_kernel", "ln_bwd_kernel", "reduce_partials_kernel"}
HD_ROUTE_KERNELS = {
    ("backbone_fwd", 0): {"layernorm_kernel", "gemm_kernel", "attention_bwd_kernel"},
    ("backbone_fwd", 1): {"layernorm_kernel", "gemm_f32_kernel", "flash_fwd_kernel"},
    ("mlp_bwd", 0): {"rowblock_gemm_kernel", "wgrad_kernel", "reduce_all_kernel"},
    ("mlp_bwd", 1): HD_SEQ_BWD | {"gemm_f32_kernel"},
    ("attn_bwd", 0): HD_SEQ_BWD | {"gemm_kernel", "attention_bwd_kernel"},
    ("attn_bwd", 1): HD_SEQ_BWD | {"gemm_f32_kernel", "flash_fwd_kernel",
                                   "flash_bwd_rows_kernel", "flash_bwd_cols_kernel"},
    ("flash_fwd", 0): {"flash_fwd_tc"},
    ("flash_fwd", 1): {"flash_fwd_kernel"},
    ("flash_bwd", 0): {"flash_bwd_rows_tc", "flash_bwd_cols_tc"},
    ("flash_bwd", 1): {"flash_bwd_rows_kernel", "flash_bwd_cols_kernel"},
}
for _fp32 in (0, 1):
    HD_ROUTE_KERNELS[("layer_fwd", _fp32)] = HD_ROUTE_KERNELS[("backbone_fwd", _fp32)]
    HD_ROUTE_KERNELS[("merged_bwd", _fp32)] = (HD_ROUTE_KERNELS[("mlp_bwd", _fp32)]
                                               | HD_ROUTE_KERNELS[("attn_bwd", _fp32)])


def kernel_base(name: str) -> str:
    """A traced kernel's function name without its template arguments."""
    m = re.search(r"([A-Za-z_]\w*)\s*[<(]", re.sub(r"^void ", "", name))
    return m.group(1) if m else name


def hd_cuda_counts(fb, fa, geoms) -> None:
    """Each route's CUDA launches at every geometry of `geoms` and dtype as
    the C entries count them, against hd_predicted_launches."""
    for label, d, heads, mlp in geoms:
        got, want = {}, {}
        for fp32 in (0, 1):
            for name, _, _ in HD_KERNELS:
                tag = f"{name}{' fp32' if fp32 else ''}"
                if name == "backbone_fwd":
                    got[tag] = fb.kernel_launches_per_layer(d, bool(fp32), heads, mlp)
                elif name.startswith("flash"):
                    got[tag] = fb.cuda_launches(name, fa.KERNEL_NAME)
                else:
                    got[tag] = fb.cuda_launches(name, None, d, fp32, heads=heads, mlp=mlp)
                want[tag] = hd_predicted_launches(name, d, heads, mlp, fp32)
        log(f"[hd-launches] {label} heads={heads} mlp={mlp}: CUDA launches per call (forwards "
            f"per layer) {got}")
        if got != want:
            raise AssertionError(f"{label}: CUDA launches {got}, predicted {want}")


def hd_launch_counts(fb, fa) -> None:
    """Phase 17 (b), (c): each route's CUDA launches at every HD_GEOMS
    geometry and dtype against hd_predicted_launches (hd_cuda_counts), then
    hd_trace in a fresh process (`python3 chip_smoke.py --hd-trace`): late
    in the whole script a trace in this process drops device kernels (in
    whole runs on the H100: 27 of 70 backbone_fwd kernels, 0 of 10
    flash_fwd), while the first traces of a process hold them all."""
    hd_cuda_counts(fb, fa, HD_GEOMS)
    gc.collect()
    torch.cuda.empty_cache()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--hd-trace"],
                        timeout=600).returncode
    if rc != 0:
        raise AssertionError(f"chip_smoke.py --hd-trace exited with {rc}")


def hd_trace(fb, fa, dev) -> None:
    """Phase 17 (b), (c), the traced half, in a process of its own: at
    ViT-Tiny's width with 6 heads, B = 5, S = 197, each wrapper's route
    (HD_ROUTE_KERNELS: every one of its kernels, no other) and exactly
    STAGE_CALLS times its predicted launches in a trace of STAGE_CALLS
    calls; two runs of each backward equal bit for bit; bf16 and fp32."""
    d, heads, mlp, eps = HD_TIME_D, 6, HD_TIME_MLP, 1e-12
    gen = torch.Generator().manual_seed(SEED + 170)
    for dtype in (torch.bfloat16, torch.float32):
        wt = tuple(t if t.dtype == torch.float32 else t.to(dtype)
                   for t in random_backbone(gen, 1, d, mlp, dev))
        w = layer_weights(fb.WEIGHT_NAMES, wt)
        x, x2, g, q, k, v, do = hd_operands(gen, 5, 197, d, heads, dtype, dev)
        fp32 = int(dtype == torch.float32)
        calls = {"backbone_fwd": lambda: fb.fused_backbone(x, wt, heads, eps, True),
                 "layer_fwd": lambda: fb.layer_fwd(x, tuple(t[0] for t in wt), heads, eps, True),
                 "mlp_bwd": lambda: fb.mlp_bwd(x2, g, w, eps, True),
                 "attn_bwd": lambda: fb.attn_bwd(x, g, w, heads, eps),
                 "merged_bwd": lambda: fb.merged_bwd(x, x2, g, w, heads, eps, True),
                 "flash_fwd": lambda: fa.flash_fwd(q, k, v),
                 "flash_bwd": lambda: fa.flash_bwd(q, k, v, do)}
        for name, fn in calls.items():
            n_want = STAGE_CALLS * hd_predicted_launches(name, d, heads, mlp, fp32)
            totals = {}
            stage_breakdown(lambda: [fn() for _ in range(STAGE_CALLS)], totals=totals)
            traced = sum(n for _, n in totals.get("kernels", {}).values())
            names = {kernel_base(k) for k in totals.get("kernels", {})}
            route = HD_ROUTE_KERNELS[(name, fp32)]
            same = True
            if name.endswith("bwd"):
                runs = [tensors_of(fn()) for _ in range(2)]
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(*runs))
                del runs
            log(f"[hd-launches] {name} {str(dtype)[6:]} D={d} heads={heads} B=5 S=197: "
                f"{traced} device kernels traced over {STAGE_CALLS} calls (predicted "
                f"{n_want}), of {sorted(names)}; two runs bitwise equal {same}")
            if names != route or traced != n_want:
                raise AssertionError(f"{name} at head_dim 32 ran {sorted(names)} ({traced} "
                                     f"launches in {STAGE_CALLS} calls, predicted {n_want}), "
                                     f"its route {sorted(route)}")
            if not same:
                raise AssertionError(f"{name} at head_dim 32 is not deterministic")
        del wt, w, x, x2, g, q, k, v, do
        torch.cuda.empty_cache()


def hd_cli_run(what, argv, want) -> dict:
    """One CLI command with the counters set to 0 just before and read just
    after, held to `want` (None: only that it ran). Returns the counts."""
    import contextlib
    import io

    from vit2spn_tpu_torch.cli import main as cli_main

    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = read_launches()
    ran = {k: n for k, n in launches.items() if n}
    log(f"[hd-main] {what}: rc {rc} in {secs:.1f} s, launches {ran}"
        + (f" (predicted {want})" if want is not None else ""))
    if rc != 0:
        raise AssertionError(f"{what}: rc {rc}")
    if want is not None and launches != {k: want.get(k, 0) for k in launches}:
        raise AssertionError(f"{what} launched {ran}, predicted {want}")
    return launches


def hd_step_check(cfg, images, label, loss=True, fp32=True) -> None:
    """Step 1 of phase 17 (d) from one state (exact gelu): "fused" against
    "plain" (its kernels' twins, the same rounding points: compare_steps'
    tolerances, the loss too where `loss`, as phase 9) and against "xla"
    (the per-op path, which rounds at other points: the moments and the
    updated params, as phase 14 holds it); in fp32 "fused" against "xla"
    (the same function), where `fp32` (the tiny model; at ViT-Tiny's width
    (a) holds the fp32 kernels at the main path's B and S). At ViT-Tiny's 12
    layers of random features the loss sits near 0 (0.0117 at 6 heads on
    the H100), where the relative loss bound measures its denominator, so
    `loss` is False there, as phase 14 leaves it out at the zoo's widths;
    the moments and the updated params are held as everywhere."""
    from vit2spn_tpu_torch.train import checkpoint as ckpt
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    gelu_env = os.environ.get("VIT2SPN_FAST_GELU")
    os.environ["VIT2SPN_FAST_GELU"] = "0"
    runs = {}
    try:
        for impl in ("fused", "plain", "xla"):
            tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), attn_impl=impl,
                            device="cuda")
            before = ckpt._flatten(tr.state)
            value = float(tr.train_step(images, (0, 0))["loss"])
            runs[impl] = (value, before, ckpt._flatten(tr.state))
            del tr
            gc.collect()
            torch.cuda.empty_cache()
        params = ("params/online/", "params/heads/")
        compare_steps(f"hd-step1 {label}", ["fused", "plain"], [runs["fused"], runs["plain"]],
                      cfg.learning_rate, params, loss=loss)
        compare_steps(f"hd-step1 {label}", ["fused", "xla"], [runs["fused"], runs["xla"]],
                      cfg.learning_rate, params, loss=False)
        if fp32:
            cfg32 = replace_cfg(cfg, compute_dtype="float32")
            step_check(cfg32, images, cfg32.learning_rate, ("fused", False), ("xla", False),
                       loss=loss)
    finally:
        if gelu_env is None:
            os.environ.pop("VIT2SPN_FAST_GELU")
        else:
            os.environ["VIT2SPN_FAST_GELU"] = gelu_env


def hd_main_path(card) -> dict:
    """Phase 17 (d). Returns {head_dim: {kernel: launches}} over the main
    path's runs at that head_dim."""
    import tempfile

    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import load_dataset, synthetic_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME

    by_dh = {dh: {} for dh in HD_DIMS}

    def add(dh, launches):
        for k, n in launches.items():
            if n:
                by_dh[dh][k] = by_dh[dh].get(k, 0) + n

    # step 1 and the four paths at the tiny model (head_dim 16, 2 x 128 a
    # step) and at ViT-Tiny's width with 6 and 4 heads (head_dim 32, 48;
    # 1 x 128)
    for dh, over, a_ in ((16, HD_TINY, 2), (32, ("vit.num_heads=6",), 1),
                         (48, ("vit.num_heads=4",), 1)):
        cfg = _apply_overrides(get_preset("ssp-scratch"),
                               [*over, "batch_size=128", f"accumulation_steps={a_}"])
        if cfg.vit.head_dim != dh:
            raise AssertionError(f"{over} gave head_dim {cfg.vit.head_dim}")
        eff, a, layers = cfg.effective_batch, cfg.accumulation_steps, cfg.vit.num_layers
        tds = synthetic_dataset(split_sizes={"train": eff}, image_size=28,
                                seed=SEED + 17 + dh).split("train")
        label = f"head_dim {dh} (D={cfg.vit.hidden_size}, {cfg.vit.num_heads} heads)"
        hd_step_check(cfg, tds.images[:eff], label, loss=dh == 16, fp32=dh == 16)
        cfg32 = replace_cfg(cfg, compute_dtype="float32")
        split = {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers}
        per_layer_fwd = 2 * 2 * a * layers
        for c, impl, merged, per_step in (
                (cfg, "fused", False, {KERNEL_NAME: 2 * 2 * a, **split}),
                (cfg, "fused", True, {KERNEL_NAME: 2 * 2 * a, "merged_bwd": 2 * a * layers}),
                (cfg, "fused_layer", False, {"layer_fwd": per_layer_fwd, **split}),
                (cfg, "pallas", False, {"flash_fwd": per_layer_fwd,
                                        "flash_bwd": 2 * a * layers}),
                (cfg32, "fused", False, {KERNEL_NAME: 2 * 2 * a, **split})):
            trainer, launches, _ = fit_path(c, tds, impl, merged, per_step)
            add(dh, launches)
            os.environ["VIT2SPN_MERGED_BWD"] = "0"
            del trainer
            gc.collect()
            torch.cuda.empty_cache()
        log(f"[hd-main] {label}: step 1 of fused against xla and fp32, fits of fused, merged, "
            f"fused_layer, pallas and fp32 fused on {card}")

    # the tiny model through the CLI: SSP training in bf16 and fp32, extract,
    # fine-tune from the export, the parity smoke
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        stage_octmnist(tmp, HD_TINY_SPLITS, SEED + 171)
        over = [*HD_TINY, f"data.root={tmp}"]
        ssp_over = [*over, "batch_size=128", "accumulation_steps=2"]  # 2 steps of 2 x 128
        common = [x for o in ssp_over for x in ("-o", o)]
        cfg = _apply_overrides(get_preset("ssp-scratch"), ssp_over)
        a, layers = cfg.accumulation_steps, cfg.vit.num_layers
        steps = HD_TINY_SPLITS["train"] // cfg.effective_batch
        want = {KERNEL_NAME: steps * 2 * 2 * a, "mlp_bwd": steps * 2 * a * layers,
                "attn_bwd": steps * 2 * a * layers}
        for dtype in ("bfloat16", "float32"):
            out = os.path.join(tmp, f"ssp_{dtype}")
            add(16, hd_cli_run(f"run ssp-scratch (tiny model, {dtype}, 1 epoch of "
                               f"{HD_TINY_SPLITS['train']} images, {steps} steps)",
                               ["run", "ssp-scratch", "--epochs", "1", "--output-dir", out,
                                *common, "-o", f"compute_dtype={dtype}"], want))
            export = os.path.join(out, cfg.export_name + ".npz")
            with np.load(export) as z:
                w1 = [z[k].shape for k in z.files if k.endswith("w1")]
                finite = all(np.isfinite(z[k]).all() for k in z.files
                             if z[k].dtype.kind == "f")
            if w1 != [(layers, 32, 64)] or not finite:
                raise AssertionError(f"the tiny export's w1 is {w1}, finite {finite}")
        feats = os.path.join(tmp, "feats.npz")
        ckpt_bf16 = os.path.join(tmp, "ssp_bfloat16", "checkpoint.npz")
        got = hd_cli_run("extract ssp-scratch (tiny model, bf16, the bf16 run's checkpoint)",
                         ["extract", "ssp-scratch", "--out", feats, *common,
                          *(["--checkpoint", ckpt_bf16] if os.path.exists(ckpt_bf16) else [])],
                         None)
        add(16, got)
        with np.load(feats) as z:
            arrays = [z[k] for k in z.files if z[k].dtype.kind == "f"]
        if set(k for k, n in got.items() if n) != {KERNEL_NAME} or not arrays or not all(
                np.isfinite(t).all() for t in arrays):
            raise AssertionError(f"extract at the tiny model: launches {got}")
        preset = "ssp-ssl/ft-octmnist"
        ft_over = [*over, "k_folds=2", "init=scratch", f"init_path={export}"]
        cfg_ft = _apply_overrides(get_preset(preset), ft_over)
        octm = load_dataset("octmnist", root=tmp, allow_synthetic=False)
        ft_steps, evals, _, _ = protocol_launches(cfg_ft, octm, 1)
        add(16, hd_cli_run(f"run {preset} (tiny model from the fp32 export, 2 folds, 1 epoch)",
                           ["run", preset, "--epochs", "1", "--output-dir",
                            os.path.join(tmp, "ft"), *[x for o in ft_over for x in ("-o", o)]],
                           _wanted(ft_steps, evals, layers)))
        out_d = os.path.join(tmp, "parity_smoke")
        got = hd_cli_run("parity --smoke", ["parity", "--smoke", "--epochs", "1",
                                            "--ft-epochs", "1", "--skip-multitrial",
                                            "--out", out_d], None)
        add(16, got)
        with open(os.path.join(out_d, "parity_report.json")) as f:
            report = json.load(f)
        with open(os.path.join(out_d, "parity_metrics.jsonl")) as f:
            picked = [json.loads(line) for line in f if '"parity_attn_impl"' in line]
        log(f"[hd-main] parity --smoke: logged {[p.get('attn_impl') for p in picked]}, "
            f"report attn_impl {report.get('attn_impl')} (written only off \"fused\"), status "
            f"{report['status'][:40]!r}")
        if ("attn_impl" in report or not picked or picked[0].get("attn_impl") != "fused"
                or not report["status"].startswith("SMOKE")
                or not all(got.get(k) for k in (KERNEL_NAME, "mlp_bwd", "attn_bwd"))):
            raise AssertionError(f"parity --smoke: {report.get('attn_impl')}, launches {got}")
    for dh, launches in by_dh.items():
        missing = [k for k, _, _ in HD_KERNELS if not launches.get(k)]
        log(f"[hd-main] head_dim {dh}: launches on the main path {launches}")
        if missing:
            raise AssertionError(f"head_dim {dh}: {missing} never launched on the main path")
    return by_dh


def hd_times(fb, fa, card, dev) -> dict:
    """Phase 17 (e): each wrapper at D 192, B = 128, S = 197 (the backbone
    12 layers) for each head_dim of HD_TIME_HEADS (64: the head_dim-64
    routes at the same width), bf16, and at head_dim 32 in fp32: kernel (CUDA
    events), plain twin, library call (yardstick only; TF32 off) and bound.
    Returns {(kernel, head_dim, dtype): (ms, plain ms, library ms, bound ms,
    bound by)}."""
    b, s, d, mlp, eps = HD_TIME_B, HD_TIME_S, HD_TIME_D, HD_TIME_MLP, 1e-12
    out = {}
    for dh, heads in HD_TIME_HEADS:
        for dtype in ((torch.bfloat16, torch.float32) if dh == 32 else (torch.bfloat16,)):
            fp32 = dtype == torch.float32
            gen = torch.Generator().manual_seed(SEED + 172 + dh)
            wt = tuple(t if t.dtype == torch.float32 else t.to(dtype)
                       for t in random_backbone(gen, 12, d, mlp, dev))
            w = layer_weights(fb.WEIGHT_NAMES, wt)
            w0 = tuple(t[0] for t in wt)
            x, x2, g, q, k, v, do = hd_operands(gen, b, s, d, heads, dtype, dev)
            sdpa_in = [t.transpose(1, 2) for t in (q, k, v)]
            sdpa_bwd, _ = library_flash_bwd(q, k, v, do)
            rows = (
                ("backbone_fwd", backbone_bound_ms(b, s, d, heads, mlp, 12, wt),
                 lambda: fb.fused_backbone(x, wt, heads, eps, True),
                 lambda: fb.backbone_forward_plain(x, wt, heads, eps, True),
                 lambda: library_backbone(x, wt, heads, eps)),
                ("layer_fwd", backbone_bound_ms(b, s, d, heads, mlp, 1, w0, acts=3),
                 lambda: fb.layer_fwd(x, w0, heads, eps, True),
                 lambda: fb.layer_forward_plain(x, w0, heads, eps, True),
                 lambda: library_backbone(x, tuple(t[:1] for t in wt), heads, eps)),
                ("mlp_bwd", bwd_bound_ms("mlp", b, s, d, heads, mlp, w),
                 lambda: fb.mlp_bwd(x2, g, w, eps, True),
                 lambda: fb.mlp_bwd_plain(x2, g, w, eps, True),
                 lambda: library_mlp_half(x2, g, w, eps)),
                ("attn_bwd", bwd_bound_ms("attn", b, s, d, heads, mlp, w),
                 lambda: fb.attn_bwd(x, g, w, heads, eps),
                 lambda: fb.attn_bwd_plain(x, g, w, heads, eps),
                 lambda: library_attn_half(x, g, w, heads, eps)),
                ("merged_bwd", bwd_bound_ms("merged", b, s, d, heads, mlp, w),
                 lambda: fb.merged_bwd(x, x2, g, w, heads, eps, True),
                 lambda: fb.merged_bwd_plain(x, x2, g, w, heads, eps, True),
                 lambda: library_attn_half(x, library_mlp_half(x2, g, w, eps)[0].to(dtype), w,
                                           heads, eps)),
                ("flash_fwd", flash_bound_ms("fwd", b, s, heads, fp32, dh),
                 lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
                 lambda: F.scaled_dot_product_attention(*sdpa_in)),
                ("flash_bwd", flash_bound_ms("bwd", b, s, heads, fp32, dh),
                 lambda: fa.flash_bwd(q, k, v, do),
                 lambda: fa.flash_attention_bwd_plain(q, k, v, do), sdpa_bwd),
            )
            for name, (b_ms, b_by, flops), kernel, twin, library in rows:
                k_ms = time_ms(kernel, iters=10, warmup=2)
                p_ms = time_ms(twin, iters=2, warmup=1)
                fwd = name.endswith("fwd")
                with torch.no_grad() if fwd else torch.enable_grad():
                    l_ms = time_ms(library, iters=10, warmup=2)
                out[(name, dh, "fp32" if fp32 else "bf16")] = (k_ms, p_ms, l_ms, b_ms, b_by)
                log(f"[time] {name} head_dim {dh} ({heads} heads, {str(dtype)[6:]}) B={b} "
                    f"S={s} D={d}: kernel {k_ms:.4f} ms, plain twin {p_ms:.3f} ms, library "
                    f"{l_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP), "
                    f"kernel at {flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
                    f"{100 * b_ms / k_ms:.1f}% of the bound; {card}")
            del wt, w, w0, x, x2, g, q, k, v, do, sdpa_in, sdpa_bwd
            gc.collect()
            torch.cuda.empty_cache()
    return out


def hd_ptxas(libs) -> None:
    """The registers and spill stores of every kernel instantiated on a
    head_dim other than 64, and of the forward-only core (its last template
    argument 1) at every head_dim."""
    for name, lib in libs.items():
        for line in ptxas_report(open(f"{lib}.log").read(), None, head_dims=True):
            log(f"[hd-build] {name}: {line}")


def head_dim_path(fb, fa, card, dev, libs=None) -> list:
    """Phase 17 (a)-(e), with the new instantiations' ptxas report where
    `libs` is given (`--head-dim`). Returns its `kernels` entries: one per
    kernel and head_dim (16, 32, 48; bf16, and fp32 at head_dim 32),
    `launches` from (d)'s main path at that head_dim, times from (e), beside
    them the head_dim-64 route's at the same width (`head_dim_64_ms`)."""
    t_phase = time.perf_counter()
    if libs:
        hd_ptxas(libs)
    errs = hd_kernels(fb, fa, dev)
    log(f"[hd] (a) in {time.perf_counter() - t_phase:.1f} s: largest absolute differences "
        f"from the twins { {f'{k} hd{dh} {dt}': round(e, 6) for (k, dh, dt), e in errs.items()} }")
    t0 = time.perf_counter()
    hd_launch_counts(fb, fa)
    log(f"[hd] (b), (c) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches = hd_main_path(card)
    log(f"[hd] (d) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = hd_times(fb, fa, card, dev)
    log(f"[hd] (e) in {time.perf_counter() - t0:.1f} s; phase 17 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    entries = []
    for dh, heads in HD_TIME_HEADS[:3]:
        for dt in ("bf16", "fp32") if dh == 32 else ("bf16",):
            for name, src, replaces in HD_KERNELS:
                k_ms, p_ms, l_ms, b_ms, b_by = times[(name, dh, dt)]
                entries.append({
                    "name": f"{name} ({'fp32, ' if dt == 'fp32' else ''}head_dim {dh})",
                    "route": "cuda", "source": f"vit2spn_tpu_torch/csrc/{src}",
                    "replaces": replaces, "launches": launches[dh].get(name, 0),
                    "max_abs_err": errs[(name, dh, dt)], "ms": k_ms, "plain_ms": p_ms,
                    "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
                    "dtype": "float32" if dt == "fp32" else "bfloat16",
                    "shape": f"B={HD_TIME_B} S={HD_TIME_S} D={HD_TIME_D} heads={heads}",
                    "head_dim_64_ms": times[(name, 64, "bf16")][0] if dt == "bf16" else None,
                })
                if not entries[-1]["launches"]:
                    raise AssertionError(f"{entries[-1]['name']} was never launched on the "
                                         "main path")
    return entries


# ---------------------------------------------------------------------------
# Phase 18: ViT-Large/16 (Dosovitskiy et al. 2021, Table 1: 24 layers, D
# 1024, mlp 4096, 16 heads, 307M parameters; HF google/vit-large-patch16-224)
# at full width and depth, through the dotted overrides (neither CLI has a
# shorthand for it). Above D = 768 the LayerNorm rows keep 32 values a lane
# (csrc/common.cuh LN_PL_WIDE), the backward's wide route tiles N = D in 256
# columns and its attention half's stage 1 keeps its 128 KB LN tile beside a
# ring of 128-column stages.
VL_LABEL, VL_D, VL_HEADS, VL_MLP, VL_LAYERS = "ViT-Large", 1024, 16, 4096, 24
VL_OVERRIDES = ("vit.hidden_size=1024", "vit.num_heads=16", "vit.mlp_dim=4096",
                "vit.num_layers=24")
# (a)'s shapes, (B, S, fast gelu): a ragged B, S = 17 and the training shape
# (the fp32 references, and the bit and launch checks at the last) for every
# kernel; the forward also at the serving shape
VL_SHAPES = ((7, 197, False), (3, 17, True), (128, 197, True))
VL_SERVE = (256, 197, False)
# The 24-layer forward against its twin, relative to the twin's largest
# magnitude: twice ZOO_FWD_REL_TOL, set at 12 layers, for twice the depth
# (the residual stream carries each layer's one-step bf16 differences
# through the later layers, as BWD12_* allow for the 12-layer backward; on
# the H100 the B=128 forward read 0.0207 / 0.00145 at 24 layers). Every
# shape also holds the kernel as close to fp32 as the twin
# (KERNEL_VS_FP32_RATIO), which a forward of another function fails.
VL_FWD_REL_TOL = (4e-2, 4e-3)
# CUDA launches of one call: the wide routes', none of common.cuh's mma.sync
# GEMM (7 a layer forward, 7 + 7 backward, merged 13), and the flash pair's
VL_CUDA_LAUNCHES = {"mlp_bwd": 7, "attn_bwd": 7, "merged_bwd": 13,
                    "backbone_fwd": 7 * VL_LAYERS, "layer_fwd": 7, "flash_fwd": 1,
                    "flash_bwd": 2}
# (a)'s other geometries: a width between ViT-Base and ViT-Large (14 heads
# of 64: the forward's wide route, the backward's mma.sync sequences), and
# ViT-Large at 384 px (S = 577: the long routes at 16 heads), 2 layers each
# (the widest LayerNorm row's refusal is phase 20's: VH_REFUSED)
VL_MID = ("D=896", 896, 14, 3584)
VL_LONG = (2, 577)  # (B, S)
# (b): `ssp-scratch` with VL_OVERRIDES, bf16, cut from 8 x 128 to 2 x 64
# images a step and (for the script's time, since phase 20 came in) from 24
# layers to VL_TRAIN_LAYERS; every kernel and route of the step is
# the same at 8 layers, and (a) and (d) keep all 24; (c): extract at batch
# 256 from that trainer
VL_MICRO, VL_ACCUM = 64, 2
VL_TRAIN_LAYERS = 8
VL_EXTRACT = 512
VL_CHILD_TIMEOUT = 600  # s; the phase took 91 s alone on the H100


def vl_kernels(fb, fa, dev) -> dict:
    """Phase 18 (a). Returns {kernel: largest absolute difference from the
    twin} at D = 1024, S = 197."""
    eps, d, heads, mlp = 1e-12, VL_D, VL_HEADS, VL_MLP
    gen = torch.Generator().manual_seed(SEED + 18)
    wt = random_backbone(gen, VL_LAYERS, d, mlp, dev)
    w0 = tuple(t[0] for t in wt)
    w = layer_weights(fb.WEIGHT_NAMES, wt)
    errs = {k: 0.0 for k in VL_CUDA_LAUNCHES}
    for b, s, fast in VL_SHAPES + (VL_SERVE,):
        x, x2, g = (torch.randn(b, s, d, generator=gen) for _ in range(3))
        x, x2, g = (t.to(torch.bfloat16).to(dev) for t in (x, x2, 0.1 * g))
        tag = f"{VL_LABEL} B={b} S={s} fast_gelu={fast}"
        errs["backbone_fwd"] = max(errs["backbone_fwd"], check_backbone_fwd(
            tag, fb, x, wt, heads, eps, fast, VL_FWD_REL_TOL))
        if (b, s, fast) == VL_SERVE:
            break
        errs["layer_fwd"] = max(errs["layer_fwd"], check_layer_fwd(
            tag, fb, x, w0, heads, eps, fast, b == TRAIN_BATCH))
        for k, v in check_layer_bwd(tag, fb, x, g, w, heads, eps, fast,
                                    against_fp32=b == TRAIN_BATCH).items():
            errs[k] = max(errs[k], v)
        errs["merged_bwd"] = max(errs["merged_bwd"], check_merged_bwd(
            tag, fb, x, x2, g, w, heads, eps, fast, True))
        if b != TRAIN_BATCH:
            continue
        with torch.no_grad():
            h = x
            for l in range(VL_LAYERS):
                h = fb.fused_block(h, tuple(t[l] for t in wt), heads, eps, fast)
            share = equal_bits(h, fb.fused_backbone(x, wt, heads, eps, fast))
        log(f"[vl] {tag}: {VL_LAYERS} fused_block calls vs one fused_backbone: "
            f"{100.0 * share:.4f}% of the outputs equal bit for bit (must be 100%)")
        if share != 1.0:
            raise AssertionError("the per-layer forward differs from the backbone at D=1024")
        calls = {"backbone_fwd": lambda: fb.fused_backbone(x, wt, heads, eps, fast, True),
                 "layer_fwd": lambda: fb.layer_fwd(x, w0, heads, eps, fast),
                 "mlp_bwd": lambda: fb.mlp_bwd(x2, g, w, eps, fast),
                 "attn_bwd": lambda: fb.attn_bwd(x, g, w, heads, eps),
                 "merged_bwd": lambda: fb.merged_bwd(x, x2, g, w, heads, eps, fast)}
        for name, fn in calls.items():
            n_cuda = (VL_LAYERS * fb.kernel_launches_per_layer(d, False, heads, mlp)
                      if name == "backbone_fwd"
                      else fb.cuda_launches(name, None, d, 0, heads=heads, mlp=mlp))
            check_zoo_call(f"{VL_LABEL} {name} B={b} S={s}", name, fn, d, n_cuda,
                           VL_CUDA_LAUNCHES[name])
        # the flash pair at 16 heads, and the fp32 routes, at the training shape
        q, k, v, do = flash_operands(gen, b, s, heads, torch.bfloat16, dev)
        for name, e in check_flash(f"{VL_LABEL} B={b} S={s}", q, k, v, do).items():
            errs[name] = e
            check_zoo_call(f"{VL_LABEL} {name} B={b} S={s}", name,
                           (lambda: fa.flash_fwd(q, k, v)) if name == "flash_fwd"
                           else (lambda: fa.flash_bwd(q, k, v, do)), d,
                           fb.cuda_launches(name, fa.KERNEL_NAME), VL_CUDA_LAUNCHES[name])
        check_fp32_layer(f"{VL_LABEL} fp32 B={b} S={s}", fb, x.float(), x2.float(),
                         g.float(), w, heads, eps, fast)
        del q, k, v, do, h
    del wt, w0, w, x, x2, g
    torch.cuda.empty_cache()
    # a width between, and 384 px (the long routes), 2 layers each
    for label, d_, heads_, mlp_, b, s in ((*VL_MID, 7, 197),
                                          (f"{VL_LABEL} 384 px", d, heads, mlp, *VL_LONG)):
        wt = random_backbone(gen, 2, d_, mlp_, dev)
        w = layer_weights(fb.WEIGHT_NAMES, wt)
        x, x2, g = (torch.randn(b, s, d_, generator=gen) for _ in range(3))
        x, x2, g = (t.to(torch.bfloat16).to(dev) for t in (x, x2, 0.1 * g))
        tag = f"{label} D={d_} heads={heads_} mlp={mlp_} B={b} S={s}"
        check_backbone_fwd(tag, fb, x, wt, heads_, eps, True)
        check_layer_bwd(tag, fb, x, g, w, heads_, eps, True, against_fp32=True)
        check_merged_bwd(tag, fb, x, x2, g, w, heads_, eps, True, True)
        if s > fb.KERNEL_MAX_SEQ:  # fp32 above 256 tokens too
            x32, wt32 = x.float(), tuple(t.float() for t in wt)
            check_fp32_outputs(
                "fused_backbone-fp32", f"{tag} L=2", ("out",),
                (fb.fused_backbone(x32, wt32, heads_, eps, True),),
                (fb.backbone_forward_plain(x32, wt32, heads_, eps, True),),
                (fb.backbone_forward_plain(x32.double(), tuple(t.double() for t in wt32),
                                           heads_, eps, True),), FP32_TOL)
            check_fp32_layer(f"{tag} fp32", fb, x32, x2.float(), g.float(), w, heads_, eps,
                             True)
        del wt, w, x, x2, g
        torch.cuda.empty_cache()
    return errs


def vl_training(card) -> tuple:
    """Phase 18 (b) and (c) on one SSPTrainer of `ssp-scratch` with the
    ViT-Large overrides, VL_TRAIN_LAYERS deep (its random init is drawn on
    the host, so the paths share it): step 1 (zoo_step_check); `fit` of
    two "fused" steps, one merged, one "pallas" and one fp32 "fused" step,
    every counter as predicted; the "fused" step's wall, img/s, device time
    by wrapper and card idle; then extract of VL_EXTRACT images at batch
    256 through "fused" against the plain path, with img/s and the
    forward's device time. Returns the launches of (b)'s runs by kernel."""
    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    cfg = _apply_overrides(get_preset("ssp-scratch"), [
        *VL_OVERRIDES, f"batch_size={VL_MICRO}", f"accumulation_steps={VL_ACCUM}",
        f"vit.num_layers={VL_TRAIN_LAYERS}"])
    vit = cfg.vit
    geom = (vit.hidden_size, vit.num_heads, vit.mlp_dim, vit.num_layers, vit.image_size,
            vit.seq_len, cfg.compute_dtype)
    if geom != (VL_D, VL_HEADS, VL_MLP, VL_TRAIN_LAYERS, 224, 197, "bfloat16"):
        raise AssertionError(f"the ViT-Large overrides gave {geom}")
    eff, a, layers = cfg.effective_batch, cfg.accumulation_steps, vit.num_layers
    t0 = time.perf_counter()
    tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), attn_impl="fused", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flat_tensors(tr.params.online).values()) // 2
    log(f"[vl] (b) {VL_LABEL} SSP: D={VL_D}, {VL_HEADS} heads, mlp {VL_MLP}, {layers} layers "
        f"(cut from {VL_LAYERS}), {a} x {cfg.batch_size} (cut from 8 x 128), bf16; one trainer, "
        f"{n_params} params a "
        f"backbone, built in {time.perf_counter() - t0:.1f} s")
    tds = synthetic_dataset(split_sizes={"train": 2 * eff}, image_size=28,
                            seed=SEED + 18).split("train")
    t0 = time.perf_counter()
    zoo_step_check(tr, cfg, tds.images[:eff], VL_LABEL)
    log(f"[vl] (b) step 1 checks in {time.perf_counter() - t0:.1f} s")
    fwd = {KERNEL_NAME: 2 * 2 * a}
    split = {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers}
    flash = {"flash_fwd": 2 * 2 * a * layers, "flash_bwd": 2 * a * layers}
    one = tds.subset(np.arange(eff))
    total = {}
    for impl, merged, fp32, images, per_step in (
            ("fused", False, False, tds, {**fwd, **split}),
            ("fused", True, False, one, {**fwd, "merged_bwd": 2 * a * layers}),
            ("pallas", False, False, one, flash),
            ("fused", False, True, one, {**fwd, **split})):
        pcfg = replace_cfg(cfg, compute_dtype="float32") if fp32 else cfg
        use_path(tr, pcfg, impl)
        torch.cuda.reset_peak_memory_stats()
        _, n, _ = fit_path(pcfg, images, impl, merged, per_step, trainer=tr)
        log(f"[vl] (b) {path_name(impl, merged, pcfg)}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
        if not (merged or fp32):
            for k_, v_ in n.items():
                total[k_] = total.get(k_, 0) + v_
        elif merged:
            total["merged_bwd"] = n["merged_bwd"]
        if impl == "fused" and not (merged or fp32):  # the step's time by wrapper
            totals = {}
            wrappers = (KERNEL_NAME, "mlp_bwd", "attn_bwd")
            step_s = time_steps(tr, eff, f"fused {VL_LABEL}", card, wrappers,
                                "views, embed, heads, loss, Adam, EMA", reps=2, totals=totals)
            device = totals.get("device", float("nan"))
            by = {w_: totals.get(f"vit2spn::{w_}", float("nan")) for w_ in wrappers}
            log(f"[vl] (b) fused {VL_LABEL} step ({eff} images): wall {1e3 * step_s:.2f} ms, "
                f"{eff / step_s:.1f} img/s, device {device:.3f} ms "
                f"({', '.join(f'{w_} {ms:.3f}' for w_, ms in by.items())}, the rest "
                f"{device - sum(by.values()):.3f}), card idle "
                f"{100 * (1 - device / (1e3 * step_s)):.1f}% on {card}")
        os.environ["VIT2SPN_MERGED_BWD"] = "0"
    use_path(tr, cfg, "fused")
    # (c) extract through "fused", against the plain path
    ds = synthetic_dataset(split_sizes={"all": VL_EXTRACT}, image_size=28, seed=SEED)
    tr.extract_features(ds, batch_size=BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    feats, _ = tr.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k_: n_ for k_, n_ in read_launches().items() if n_}
    want = {KERNEL_NAME: 2 * -(-VL_EXTRACT // BATCH)}  # dual stream
    totals = {}
    lines = stage_breakdown(lambda: tr.extract_features(ds, batch_size=BATCH),
                            f"{VL_LABEL} extract of {len(ds)} images", top=6,
                            wrappers=(KERNEL_NAME,), rest="views, embed, heads", totals=totals)
    tr.attn_impl = "plain"
    plain, _ = tr.extract_features(ds, batch_size=BATCH)
    scale, err = float(np.abs(plain).max()), float(np.abs(feats - plain).max())
    log(f"[vl] (c) {VL_LABEL} extract at batch {BATCH}: {feats.shape} features in {secs:.3f} s, "
        f"{len(ds) / secs:.1f} img/s, launches {launches} (want {want}); forward device "
        f"{totals.get('vit2spn::' + KERNEL_NAME, float('nan')):.3f} ms of "
        f"{totals.get('device', float('nan')):.3f} ms; vs plain max_abs_err {err:.6g} (max "
        f"|plain| {scale:.4g}, tol {FEATURE_REL_TOL} relative) on {card}")
    for line in lines:
        log(line)
    if launches != want:
        raise AssertionError(f"{VL_LABEL} extract launched {launches}, not {want}")
    if feats.shape != (len(ds), cfg.proj_dim) or not np.isfinite(feats).all():
        raise AssertionError(f"{VL_LABEL} extract: bad features {feats.shape}")
    if not err <= FEATURE_REL_TOL * scale:
        raise AssertionError(f"{VL_LABEL} features disagree with the plain path")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return total


def vl_flash_times(fb, fa, card, dev, launches, errs) -> list:
    """Phase 18 (d) for the flash pair at 16 heads, B=128, S=197: kernel,
    twin, SDPA (and its backward) and the bound, as phase 11 times them."""
    gen = torch.Generator().manual_seed(SEED + 180)
    b, s, heads = TRAIN_BATCH, 197, VL_HEADS
    q, k, v, do = flash_operands(gen, b, s, heads, torch.bfloat16, dev)
    lib_bwd, _ = library_flash_bwd(q, k, v, do)
    entries = []
    for name, replaces, kind, kernel, twin, library in (
            ("flash_fwd", "vit2spn_tpu/ops/flash_attention.py:36", "fwd",
             lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
             lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))),
            ("flash_bwd", "vit2spn_tpu/ops/flash_attention.py:53", "bwd",
             lambda: fa.flash_bwd(q, k, v, do), lambda: fa.flash_attention_bwd_plain(q, k, v, do),
             lib_bwd)):
        b_ms, b_by, b_flops = flash_bound_ms(kind, b, s, heads)
        k_ms = time_ms(kernel)
        p_ms = time_ms(twin, iters=5, warmup=1)
        with torch.no_grad() if kind == "fwd" else torch.enable_grad():
            l_ms = time_ms(library)
        n_cuda = fb.cuda_launches(name, fa.KERNEL_NAME)
        log(f"[vl-time] {VL_LABEL} {name} B={b} heads={heads}: kernel {k_ms:.4f} ms ({n_cuda} "
            f"CUDA launches), plain twin {p_ms:.3f} ms, library {l_ms:.4f} ms, bound {b_ms:.4f} "
            f"ms ({b_by}; {b_flops / 1e9:.2f} GFLOP), {100 * b_ms / k_ms:.1f}% of the bound; "
            f"{card}")
        entries.append({
            "name": f"{name} (D={VL_D})", "route": "cuda",
            "source": "vit2spn_tpu_torch/csrc/flash_attention.cu", "replaces": replaces,
            "launches": launches.get(name, 0), "max_abs_err": errs.get(name), "ms": k_ms,
            "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
            "cuda_launches": n_cuda, "dtype": "bfloat16",
        })
    return entries


def vit_large_in_child() -> list:
    """Phase 18 in a process of its own (`chip_smoke.py --vit-large`, the
    kernels already built on disk): after phases 14-17 a torch.profiler
    trace in this process held none of a flash forward's launches on the
    H100, as phase 17 (b)'s trace had held too few. Its lines are logged
    here but its last two: its `kernels` line, whose entries this returns,
    and its `ok` line."""
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--vit-large"],
                          capture_output=True, text=True, timeout=VL_CHILD_TIMEOUT)
    lines = proc.stdout.splitlines()
    for line in lines[:-2] if proc.returncode == 0 else lines:
        log(line)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0 or len(lines) < 2:
        raise AssertionError(f"chip_smoke.py --vit-large exited with {proc.returncode}")
    return json.loads(lines[-2])["kernels"]


def vit_large_path(fb, fa, card, dev) -> list:
    """Phase 18, ViT-Large/16: (a) the kernels at D = 1024 against their
    twins, (b) SSP training, (c) extract, (d) the times. Returns (d)'s
    {"kernels": [...]} entries, each kernel's `launches` from (b); a kernel
    of the path that (b) never launched fails the phase."""
    t_phase = time.perf_counter()
    errs = vl_kernels(fb, fa, dev)
    log(f"[vl] (a) in {time.perf_counter() - t_phase:.1f} s: largest absolute differences "
        f"from the twins { {k: round(e, 6) for k, e in errs.items()} }")
    t0 = time.perf_counter()
    launches = vl_training(card)
    log(f"[vl] (b), (c) in {time.perf_counter() - t0:.1f} s; launches {launches}")
    t0 = time.perf_counter()
    entries = zoo_times(fb, card, dev, {VL_D: launches}, {VL_D: errs},
                        widths=[(VL_LABEL, VL_D, VL_HEADS, VL_MLP, VL_LAYERS)])
    entries += vl_flash_times(fb, fa, card, dev, launches, errs)
    log(f"[vl] (d) in {time.perf_counter() - t0:.1f} s; phase 18 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    for e in entries:
        if not e["launches"] and not e["name"].startswith("layer_fwd"):
            raise AssertionError(f"{e['name']} was never launched on the main path")
    return entries


# ---------------------------------------------------------------------------
# Phase 19: the general route above 256 tokens. At head_dim 16, 32 and 48
# the bf16 attention above 256 keys runs csrc/general_long.cuh (the forward
# stage and the flash forward on gl_fwd_kernel, the fused backward core on
# gl_core_kernel in one launch, the flash backward on gl_flash_rows_kernel
# and gl_flash_cols_kernel) and the fp32 attention csrc/flash_f32.cuh's
# multi-pass route on the head_dim; at head_dim 64 with D or mlp not a
# multiple of 64 the general route's layer sequences call phases 15-16's
# head_dim-64 long routes. In a process of its own (`chip_smoke.py
# --general-long`), after phase 18 and before phase 13, (b)'s trace first,
# while the process's traces hold every kernel:
# (a) at GL_GEOMS (phase 17's: head_dim 16 / 32 / 48 at D 32 / 64 / 96 with
# 2 heads and D 192 with 12 / 6 / 4 heads), at GL_KERNEL_SHAPES (ragged B,
# S = 257, 290, 577), at D 192 also GL_LONGEST_SHAPES (S = 1024; fp32 also
# 1,200), and the main path's B and S (GL_MAIN_SHAPES), bf16 and fp32: the stage and the core alone (their C
# entries) and the flash pair against their twins and fp32 (bf16: phase
# 15's tolerances) or float64 (fp32: phase 16's), the core's att equal to
# the stage's, two core runs and two flash backward runs equal bit for bit;
# through the wrappers, at GL_LAYER_SHAPES and the main path's shapes, at
# GL_GEOMS and the head_dim-64 general geometries (GL_HD64_GEOMS), phase 17
# (a)'s checks (hd_kernels: the 2-layer fused_backbone with and without its
# stacks, layer_fwd, mlp_bwd, attn_bwd, merged_bwd equal to the split pair
# bit for bit, the flash pair, in bf16 and fp32, each counter raised by one
# a call); the bf16 core at its longest S (fb.LONG_CORE_MAX_SEQ, head_dim
# 16) against its twin and one query past it refused by the C entry and by
# the wrappers' check, before any launch.
# (b) a torch.profiler trace of STAGE_CALLS calls of each wrapper at
# ViT-Tiny's width with 6 heads, B = 2, S = 290, bf16 and fp32: the route's
# kernels (GL_ROUTE_KERNELS) and no other, STAGE_CALLS times
# hd_predicted_launches (the launch counts do not change above 256 keys);
# one call of each raises its counter by one and its long route's count by
# its launches of the route; two runs of each backward equal bit for bit;
# the C entries' counts at GL_HD64_GEOMS against hd_predicted_launches
# (hd_cuda_counts: merged runs each half on the route the split pair takes).
# (c) the main path: ViT-Tiny's width (D 192, mlp 768) at 6 and 4 heads at
# 384 px (`ssp-scratch -o vit.num_heads=6|4 -o vit.image_size=384 -o
# data.augment.out_size=384`, cut as phase 15 (b): 2 x 64 images a step,
# GL_TRAIN_LAYERS of the 12 layers): step 1 of "fused" against "plain" and
# "xla" (hd_step_check, as phase 17 (d) holds ViT-Tiny's width; in fp32 too
# at 6 heads), then on one trainer a head count `fit` through "fused",
# merged, "fused_layer", "pallas" and fp32 "fused" (and fp32 "pallas" at 6
# heads) with every counter as predicted; `run ft-ucsdoct` at
# 256 px (phase 15 (c)'s cut) at 6 heads in bf16 and at 4 heads in fp32; the
# tiny model (D 32, 2 heads, mlp 64) at 256 px: `run ssp-scratch` and
# `extract` through the CLI ("fused"), `fit` and extract through "pallas",
# extract through "fused" and "pallas" against the plain path; the parity
# runbook's path ("fused") at each of these geometries.
# (d) each new route's time (CUDA events) at D 192, B = 64, S = 577 and B =
# 128, S = 257, head_dim 16 / 32 / 48 (12 / 6 / 4 heads; fp32 at head_dim
# 32), beside its twin, SDPA (bf16, or fp32 with TF32 off; the flash pair
# also SDPA on fp32 copies), its bound and the head_dim-64 long route's
# kernel at the same width (3 heads). `python3 chip_smoke.py
# --general-long` runs the build and this phase alone.
GL_GEOMS = HD_GEOMS
GL_HD64_GEOMS = (("hd64 mlp96 D=64", 64, 1, 96), ("hd64 mlp736 D=192", 192, 3, 736))
GL_KERNEL_SHAPES = ((3, 257), (2, 290), (2, 577))  # (B, S)
# at D 192 only (each head_dim once more, at the longest S): bf16 and fp32,
# and fp32 alone
GL_LONGEST_SHAPES, GL_F32_SHAPES = ((1, 1024),), ((1, 1200),)
GL_LAYER_SHAPES = ((3, 257), (2, 290))
# the main path's (B, S) by (D, heads): the tiny model's microbatch of 128
# and extract's batch of 256 at 256 px; ViT-Tiny's width at 6 and 4 heads,
# its microbatch of 64 at 384 px ((c)'s steps) and of 128 at 256 px (`run
# ft-ucsdoct`)
GL_MAIN_SHAPES = {(32, 2): ((128, 257), (256, 257)), (192, 6): ((128, 257), (64, 577)),
                  (192, 4): ((64, 577), (128, 257))}
GL_TRAIN_LAYERS = 6
GL_TINY_256 = tuple(o for o in HD_TINY if not o.startswith(("vit.image_size",
                                                            "data.augment.out_size"))) + (
    "vit.image_size=256", "data.augment.out_size=256")
GL_TIME_SHAPES = (("384 px", LONG_MICRO, 577), ("256 px", TRAIN_BATCH, 257))  # at D 192
GL_TIME_HEADS = ((16, 12), (32, 6), (48, 4))  # (head_dim, heads) at D 192
GL_CHILD_TIMEOUT = 600  # s
GL_NEW_KERNELS = ("gl_fwd_kernel", "gl_core_kernel", "gl_flash_rows_kernel",
                  "gl_flash_cols_kernel", "long_fwd_f32_kernel", "long_bwd_rows_f32_kernel",
                  "long_bwd_cols_f32_kernel")
GL_F32_LONG = {"long_fwd_f32_kernel"}
GL_F32_LONG_BWD = {"long_bwd_rows_f32_kernel", "long_bwd_cols_f32_kernel"}
# The kernels each wrapper's route runs above 256 keys at ViT-Tiny's width
# with 6 heads (head_dim 32), by (wrapper, fp32)
GL_ROUTE_KERNELS = {
    ("backbone_fwd", 0): {"layernorm_kernel", "gemm_kernel", "gl_fwd_kernel"},
    ("backbone_fwd", 1): {"layernorm_kernel", "gemm_f32_kernel"} | GL_F32_LONG,
    ("mlp_bwd", 0): HD_ROUTE_KERNELS[("mlp_bwd", 0)],
    ("mlp_bwd", 1): HD_ROUTE_KERNELS[("mlp_bwd", 1)],
    ("attn_bwd", 0): HD_SEQ_BWD | {"gemm_kernel", "gl_core_kernel"},
    ("attn_bwd", 1): HD_SEQ_BWD | {"gemm_f32_kernel"} | GL_F32_LONG | GL_F32_LONG_BWD,
    ("flash_fwd", 0): {"gl_fwd_kernel"},
    ("flash_fwd", 1): GL_F32_LONG,
    ("flash_bwd", 0): {"gl_flash_rows_kernel", "gl_flash_cols_kernel"},
    ("flash_bwd", 1): GL_F32_LONG_BWD,
}
for _fp32 in (0, 1):
    GL_ROUTE_KERNELS[("layer_fwd", _fp32)] = GL_ROUTE_KERNELS[("backbone_fwd", _fp32)]
    GL_ROUTE_KERNELS[("merged_bwd", _fp32)] = (GL_ROUTE_KERNELS[("mlp_bwd", _fp32)]
                                               | GL_ROUTE_KERNELS[("attn_bwd", _fp32)])
# the long-sequence route each wrapper counts, and how many a call
GL_WRAPPER_ROUTES = {"backbone_fwd": "attention_fwd", "layer_fwd": "attention_fwd",
                     "attn_bwd": "attention_bwd", "merged_bwd": "attention_bwd",
                     "flash_fwd": "flash_fwd", "flash_bwd": "flash_bwd"}


def gl_trace(fb, fa, dev, geom=(HD_TIME_D, 6, HD_TIME_MLP, 2, 290), routes=None,
             seed=SEED + 190, tag="gl") -> None:
    """Phase 19 (b) (and 20 (a) at ViT-Huge's width): at `geom` (D, heads,
    mlp, B, S; by default ViT-Tiny's width with 6 heads, B = 2, S = 290),
    each wrapper in bf16 and fp32: one call raises its own counter by one and
    its long route's count by one, nothing else; a trace of STAGE_CALLS
    calls holds the route's kernels (`routes`, GL_ROUTE_KERNELS by default)
    and no other, STAGE_CALLS times its predicted CUDA launches; two runs of
    each backward equal bit for bit."""
    d, heads, mlp, b, s = geom
    eps, routes, dh = 1e-12, routes or GL_ROUTE_KERNELS, d // heads
    gen = torch.Generator().manual_seed(seed)
    for dtype in (torch.bfloat16, torch.float32):
        wt = tuple(t if t.dtype == torch.float32 else t.to(dtype)
                   for t in random_backbone(gen, 1, d, mlp, dev))
        w = layer_weights(fb.WEIGHT_NAMES, wt)
        x, x2, g, q, k, v, do = hd_operands(gen, b, s, d, heads, dtype, dev)
        fp32 = int(dtype == torch.float32)
        calls = {"backbone_fwd": lambda: fb.fused_backbone(x, wt, heads, eps, True),
                 "layer_fwd": lambda: fb.layer_fwd(x, tuple(t[0] for t in wt), heads, eps, True),
                 "mlp_bwd": lambda: fb.mlp_bwd(x2, g, w, eps, True),
                 "attn_bwd": lambda: fb.attn_bwd(x, g, w, heads, eps),
                 "merged_bwd": lambda: fb.merged_bwd(x, x2, g, w, heads, eps, True),
                 "flash_fwd": lambda: fa.flash_fwd(q, k, v),
                 "flash_bwd": lambda: fa.flash_bwd(q, k, v, do)}
        for name, fn in calls.items():
            reset_launches()
            fn()
            torch.cuda.synchronize()
            counts = {k_: n for k_, n in read_launches().items() if n}
            want = {name: 1}
            if name in GL_WRAPPER_ROUTES:
                want[f"{GL_WRAPPER_ROUTES[name]} (S>256)"] = 1
            n_want = STAGE_CALLS * hd_predicted_launches(name, d, heads, mlp, fp32)
            totals = {}
            stage_breakdown(lambda: [fn() for _ in range(STAGE_CALLS)], totals=totals)
            traced = sum(n for _, n in totals.get("kernels", {}).values())
            names = {kernel_base(k_) for k_ in totals.get("kernels", {})}
            route = routes[(name, fp32)]
            same = True
            if name.endswith("bwd"):
                runs = [tensors_of(fn()) for _ in range(2)]
                torch.cuda.synchronize()
                same = all(torch.equal(a_, b_) for a_, b_ in zip(*runs))
                del runs
            log(f"[{tag}-launches] {name} {str(dtype)[6:]} D={d} heads={heads} B={b} S={s}: "
                f"counters {counts} (want {want}); {traced} device kernels traced over "
                f"{STAGE_CALLS} calls (predicted {n_want}), of {sorted(names)}; two runs "
                f"bitwise equal {same}")
            if counts != want:
                raise AssertionError(f"one {name} call at S = {s} counted {counts}, not {want}")
            if names != route or traced != n_want:
                raise AssertionError(f"{name} at head_dim {dh}, S = {s} ran {sorted(names)} "
                                     f"({traced} launches in {STAGE_CALLS} calls, predicted "
                                     f"{n_want}), its route {sorted(route)}")
            if not same:
                raise AssertionError(f"{name} at head_dim {dh}, S = {s} is not deterministic")
        del wt, w, x, x2, g, q, k, v, do
        torch.cuda.empty_cache()


def gl_check_shape(fb, fa, dev, gen, label, d, heads, b, s, dtype, note) -> None:
    """Phase 19 (a)'s checks of the head_dim D / heads attention kernels at
    one (B, S, dtype) (and 20 (a)'s at head_dim 80): bf16, the stage and the
    core alone (their C entries) against their twins and fp32, the core's
    att equal to the stage's and two core runs equal bit for bit; fp32, the
    stage and core pair against the fp32 twins and float64; the flash pair
    against its twins and fp32 / float64, two flash backward runs equal.
    `note(route, dh, dt, e)` receives each route's largest absolute
    difference from the twin."""
    names = ("att", "dq", "dk", "dv")
    dh = d // heads
    thirds = lambda t: (t[0], *t[1].split(d, dim=-1))  # noqa: E731
    dt = "fp32" if dtype == torch.float32 else "bf16"
    tag = f"{label} heads={heads} S={s} B={b} {dt}"
    qkv = torch.randn(b, s, 3 * d, generator=gen).to(dtype).to(dev)
    datt = (0.1 * torch.randn(b, s, d, generator=gen)).to(dtype).to(dev)
    if dt == "bf16":
        att_f = attention_stage_call(fb, qkv, heads)
        att_b, dqkv = attention_core_call(fb, qkv, datt, heads)
        torch.cuda.synchronize()
        note("attention_fwd", dh, dt, check_rel(
            f"stage {tag}", ("att",), (att_f,), (attention_stage_plain(qkv, heads),),
            (attention_stage_plain(qkv.float(), heads),), "gl"))
        note("attention_bwd", dh, dt, check_rel(
            f"core {tag}", names, thirds((att_b, dqkv)),
            thirds(fb._attention_bwd(qkv, datt, heads)),
            thirds(fb._attention_bwd(qkv.float(), datt.float(), heads)), "gl"))
        again = attention_core_call(fb, qkv, datt, heads)
        torch.cuda.synchronize()
        same_att = torch.equal(att_b, att_f)
        same = torch.equal(again[0], att_b) and torch.equal(again[1], dqkv)
        log(f"[gl-bits] {tag}: core att = stage att bit for bit {same_att}; two core "
            f"runs equal {same}")
        if not (same_att and same):
            raise AssertionError(f"general long attention bits ({tag}): att "
                                 f"{same_att}, runs {same}")
        del att_f, att_b, dqkv, again
    else:
        e32 = {"attention_fwd": 0.0, "attention_bwd": 0.0}
        check_fp32_core_pair(fb, tag, qkv, datt, heads, e32)
        for route, e in e32.items():
            note(route, dh, dt, e)
    del qkv, datt
    q, k, v, do = flash_operands(gen, b, s, heads, dtype, dev, dh)
    for route, e in check_flash(f"gl {tag}", q, k, v, do).items():
        note(route, dh, dt, e)
    runs = [fa.flash_bwd(q, k, v, do) for _ in range(2)]
    torch.cuda.synchronize()
    if not all(torch.equal(x_, y_) for x_, y_ in zip(*runs)):
        raise AssertionError(f"the flash backward is not deterministic ({tag})")
    del q, k, v, do, runs
    torch.cuda.empty_cache()


def gl_kernels(fb, fa, dev) -> dict:
    """Phase 19 (a), the kernels alone. Returns {(route, head_dim, dtype):
    largest absolute difference from the twin}."""
    errs = {}

    def note(route, dh, dt, e):
        errs[(route, dh, dt)] = max(errs.get((route, dh, dt), 0.0), e)

    for label, d, heads, _ in GL_GEOMS:
        gen = torch.Generator().manual_seed(SEED + 19 + d + heads)
        wide = d == HD_TIME_D
        shapes = [(b, s, dt) for b, s in GL_KERNEL_SHAPES + GL_MAIN_SHAPES.get((d, heads), ())
                  + (GL_LONGEST_SHAPES if wide else ()) for dt in (torch.bfloat16, torch.float32)]
        for b, s, dtype in shapes + [(b, s, torch.float32) for b, s in GL_F32_SHAPES if wide]:
            gl_check_shape(fb, fa, dev, gen, label, d, heads, b, s, dtype, note)
    return errs


def gl_limit(fb, dev) -> None:
    """Phase 19 (a): the bf16 core at head_dim 16 (D 32, 2 heads) at its
    longest S against its twin; one query past it refused by the C entry
    (no launch) and by the wrappers' check."""
    lib = fb._load("attn_bwd")
    limit, d, heads = lib.vit2spn_attention_core_max_seq(16), 32, 2
    if limit != fb.LONG_CORE_MAX_SEQ:
        raise AssertionError(f"the core's S limit is {limit}, ops/fused_block.py says "
                             f"{fb.LONG_CORE_MAX_SEQ}")
    gen = torch.Generator().manual_seed(SEED + 191)
    qkv = (0.5 * torch.randn(1, limit, 3 * d, generator=gen)).to(torch.bfloat16).to(dev)
    datt = (0.1 * torch.randn(1, limit, d, generator=gen)).to(torch.bfloat16).to(dev)
    t0 = time.perf_counter()
    got = attention_core_call(fb, qkv, datt, heads)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    thirds = lambda t: (t[0], *t[1].split(d, dim=-1))  # noqa: E731
    check_rel(f"core at its longest S={limit}, head_dim 16 ({secs:.2f} s)",
              ("att", "dq", "dk", "dv"), thirds(got),
              thirds(fb._attention_bwd(qkv, datt, heads)),
              thirds(fb._attention_bwd(qkv.float(), datt.float(), heads)), "gl")
    del qkv, datt, got
    torch.cuda.empty_cache()
    over = torch.zeros(1, limit + 1, 3 * d, dtype=torch.bfloat16, device=dev)
    x = torch.zeros(1, limit + 1, d, dtype=torch.bfloat16, device=dev)
    rc = lib.vit2spn_attention_core(over.data_ptr(), x.data_ptr(), x.data_ptr(), over.data_ptr(),
                                    1, limit + 1, heads, d, fb._stream(dev))
    try:
        fb._check_layer_inputs(x, x, {}, fb.ATTN_NAMES, heads, {})
        raised = ""
    except ValueError as e:
        raised = str(e)
    log(f"[gl-limit] head_dim 16: at S={limit + 1} the C entry returns {rc} without a launch "
        f"and the wrappers' check raises: {raised}")
    if rc == 0 or f"S <= {limit}" not in raised:
        raise AssertionError(f"S = {limit + 1} at head_dim 16 was not refused (rc {rc}, check "
                             f"{raised!r})")
    del over, x
    torch.cuda.empty_cache()


def gl_long_launches(launches) -> dict:
    return {k_: n for k_, n in launches.items() if k_.endswith("(S>256)") and n}


def gl_main_path(card) -> dict:
    """Phase 19 (c). Returns {(head_dim, compute dtype): {"<route> (S>256)":
    launches}} over the main path's runs."""
    import tempfile

    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.evals.parity import runbook_attn_impl
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    by = {}

    def add(dh, dtype, launches):
        for k_, n in gl_long_launches(launches).items():
            by.setdefault((dh, dtype), {})
            by[(dh, dtype)][k_] = by[(dh, dtype)].get(k_, 0) + n

    def runbook(cfg, what):
        path = runbook_attn_impl(cfg.vit, "cuda", cfg.compute_dtype)
        log(f"[gl-main] the parity runbook's path at {what} (S={cfg.vit.seq_len}, head_dim "
            f"{cfg.vit.head_dim}, {cfg.compute_dtype}): {path}")
        if path != "fused":
            raise AssertionError(f"the parity runbook takes {path} at {what}")

    # ViT-Tiny's width at 6 and 4 heads, 384 px
    for heads in (6, 4):
        t0 = time.perf_counter()
        cfg = _apply_overrides(get_preset("ssp-scratch"), [
            f"vit.num_heads={heads}", "vit.image_size=384", "data.augment.out_size=384",
            f"batch_size={LONG_MICRO}", f"accumulation_steps={LONG_ACCUM}",
            f"vit.num_layers={GL_TRAIN_LAYERS}"])
        vit = cfg.vit
        dh = vit.head_dim
        geom = (vit.image_size, vit.hidden_size, vit.mlp_dim, vit.num_layers, vit.seq_len)
        if geom != (384, 192, 768, GL_TRAIN_LAYERS, 577) or dh != 192 // heads:
            raise AssertionError(f"the ViT-Tiny 384 px overrides gave {geom}, head_dim {dh}")
        label = f"ViT-Tiny width, {heads} heads (head_dim {dh}), 384 px"
        eff, a, layers = cfg.effective_batch, cfg.accumulation_steps, vit.num_layers
        tds = synthetic_dataset(split_sizes={"train": 2 * eff}, image_size=28,
                                seed=SEED + 19 + heads).split("train")
        hd_step_check(cfg, tds.images[:eff], label, loss=False, fp32=heads == 6)
        tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), attn_impl="fused", device="cuda")
        fwd = {KERNEL_NAME: 2 * 2 * a, "attention_fwd (S>256)": 2 * 2 * a * layers}
        split = {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers,
                 "attention_bwd (S>256)": 2 * a * layers}
        merged = {"merged_bwd": 2 * a * layers, "attention_bwd (S>256)": 2 * a * layers}
        layer = {"layer_fwd": 2 * 2 * a * layers, "attention_fwd (S>256)": 2 * 2 * a * layers,
                 **split}
        flash = {"flash_fwd": 2 * 2 * a * layers, "flash_bwd": 2 * a * layers,
                 "flash_fwd (S>256)": 2 * 2 * a * layers, "flash_bwd (S>256)": 2 * a * layers}
        cfg32 = replace_cfg(cfg, compute_dtype="float32")
        one = tds.subset(np.arange(eff))
        runs = [(cfg, "fused", False, tds, {**fwd, **split}),
                (cfg, "fused", True, one, {**fwd, **merged}),
                (cfg, "fused_layer", False, one, layer),
                (cfg, "pallas", False, one, flash),
                (cfg32, "fused", False, one, {**fwd, **split})]
        if heads == 6:
            runs.append((cfg32, "pallas", False, one, flash))
        for c, impl, is_merged, images, per_step in runs:
            use_path(tr, c, impl)
            _, n, _ = fit_path(c, images, impl, is_merged, per_step, trainer=tr)
            add(dh, c.compute_dtype, n)
            os.environ["VIT2SPN_MERGED_BWD"] = "0"
        runbook(cfg, label)
        runbook(cfg32, label)
        log(f"[gl-main] {label}: step 1 against plain and xla, fits of fused, merged, "
            f"fused_layer, pallas, fp32 fused{' and fp32 pallas' if heads == 6 else ''} in "
            f"{time.perf_counter() - t0:.1f} s on {card}")
        del tr
        gc.collect()
        torch.cuda.empty_cache()

    # `run ft-ucsdoct` at 256 px, GL_TRAIN_LAYERS deep: 6 heads in bf16, 4
    # heads in fp32
    t0 = time.perf_counter()
    depth = f"vit.num_layers={GL_TRAIN_LAYERS}"
    ft_runs = (("vit.num_heads=6", depth), ("vit.num_heads=4", "compute_dtype=float32", depth))
    for ft_over, (launches, _) in zip(ft_runs, long_ft_runs(card, ft_runs)):
        cfg = _apply_overrides(get_preset("ft-ucsdoct"), [*LONG_FT_OVERRIDES, *ft_over])
        add(cfg.vit.head_dim, cfg.compute_dtype, launches)
        runbook(cfg, f"ft-ucsdoct at 256 px, {cfg.vit.num_heads} heads")
    log(f"[gl-main] run ft-ucsdoct at 256 px, {GL_TRAIN_LAYERS} layers, 6 heads bf16 and 4 "
        f"heads fp32 in {time.perf_counter() - t0:.1f} s")

    # the tiny model at 256 px: train and serve through "fused" (the CLI) and
    # "pallas"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        stage_octmnist(tmp, HD_TINY_SPLITS, SEED + 192)
        over = [*GL_TINY_256, f"data.root={tmp}", "batch_size=128", "accumulation_steps=2"]
        common = [x for o in over for x in ("-o", o)]
        cfg = _apply_overrides(get_preset("ssp-scratch"), over)
        if (cfg.vit.seq_len, cfg.vit.head_dim, cfg.vit.hidden_size) != (257, 16, 32):
            raise AssertionError(f"the tiny model at 256 px: S {cfg.vit.seq_len}, head_dim "
                                 f"{cfg.vit.head_dim}")
        runbook(cfg, "the tiny model at 256 px")
        a, layers = cfg.accumulation_steps, cfg.vit.num_layers
        steps = HD_TINY_SPLITS["train"] // cfg.effective_batch
        want = {KERNEL_NAME: steps * 2 * 2 * a, "mlp_bwd": steps * 2 * a * layers,
                "attn_bwd": steps * 2 * a * layers,
                "attention_fwd (S>256)": steps * 2 * 2 * a * layers,
                "attention_bwd (S>256)": steps * 2 * a * layers}
        out = os.path.join(tmp, "ssp")
        add(16, "bfloat16", hd_cli_run(
            f"run ssp-scratch (tiny model at 256 px, S=257, 1 epoch of "
            f"{HD_TINY_SPLITS['train']} images, {steps} steps)",
            ["run", "ssp-scratch", "--epochs", "1", "--output-dir", out, *common], want))
        feats_path = os.path.join(tmp, "feats.npz")
        ckpt_path = os.path.join(out, "checkpoint.npz")
        got = hd_cli_run("extract ssp-scratch (tiny model at 256 px, its checkpoint)",
                         ["extract", "ssp-scratch", "--out", feats_path, *common,
                          *(["--checkpoint", ckpt_path] if os.path.exists(ckpt_path) else [])],
                         None)
        add(16, "bfloat16", got)
        with np.load(feats_path) as z:
            arrays = [z[k_] for k_ in z.files if z[k_].dtype.kind == "f"]
        ran = {k_ for k_, n in got.items() if n}
        if ran != {KERNEL_NAME, "attention_fwd (S>256)"} or not arrays or not all(
                np.isfinite(t).all() for t in arrays):
            raise AssertionError(f"extract of the tiny model at 256 px: launches {got}")
        eff = cfg.effective_batch
        tds = synthetic_dataset(split_sizes={"train": eff}, image_size=28,
                                seed=SEED + 193).split("train")
        per_step = {"flash_fwd": 2 * 2 * a * layers, "flash_bwd": 2 * a * layers,
                    "flash_fwd (S>256)": 2 * 2 * a * layers,
                    "flash_bwd (S>256)": 2 * a * layers}
        trainer, n, _ = fit_path(cfg, tds, "pallas", False, per_step)
        add(16, "bfloat16", n)
        ds = synthetic_dataset(split_sizes={"all": BATCH}, image_size=28, seed=SEED)
        trainer.attn_impl = "plain"
        plain, _ = trainer.extract_features(ds, batch_size=BATCH)
        extract_path(trainer, ds, "pallas", plain, {"flash_fwd", "flash_fwd (S>256)"},
                     what="pallas (tiny model at 256 px)")
        extract_path(trainer, ds, "fused", plain, {KERNEL_NAME, "attention_fwd (S>256)"},
                     what="fused (tiny model at 256 px)")
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[gl-main] the tiny model at 256 px through the CLI and \"pallas\" in "
        f"{time.perf_counter() - t0:.1f} s")
    for key, launches in sorted(by.items()):
        log(f"[gl-main] head_dim {key[0]} {key[1]}: long-route launches on the main path "
            f"{launches}")
    return by


def gl_hd64_ms(fb, fa, dev) -> dict:
    """Phase 19 (d)'s head_dim-64 yardstick: each long route's kernel at D
    192 with 3 heads at GL_TIME_SHAPES (the routes of phases 15 and 16).
    Returns {(route, label, dtype): ms}."""
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        stage, core = ((attention_stage_f32_call, attention_core_f32_call)
                       if dtype == torch.float32 else (attention_stage_call, attention_core_call))
        for label, b, s in GL_TIME_SHAPES:
            gen = torch.Generator().manual_seed(SEED + 194 + s)
            qkv = torch.randn(b, s, 3 * HD_TIME_D, generator=gen).to(dtype).to(dev)
            datt = (0.1 * torch.randn(b, s, HD_TIME_D, generator=gen)).to(dtype).to(dev)
            q, k, v = (t.reshape(b, s, 3, 64) for t in qkv.split(HD_TIME_D, dim=-1))
            do = datt.reshape(b, s, 3, 64)
            for route, fn in (("attention_fwd", lambda: stage(fb, qkv, 3)),
                              ("attention_bwd", lambda: core(fb, qkv, datt, 3)),
                              ("flash_fwd", lambda: fa.flash_fwd(q, k, v)),
                              ("flash_bwd", lambda: fa.flash_bwd(q, k, v, do))):
                out[(route, label, dtype)] = time_ms(fn, iters=10, warmup=2)
            del qkv, datt, q, k, v, do
    return out


def gl_times(fb, fa, card, dev) -> dict:
    """Phase 19 (d). Returns {(head_dim, dtype): long_times' result}."""
    out = {}
    for dh, heads in GL_TIME_HEADS:
        for dtype in ((torch.bfloat16, torch.float32) if dh == 32 else (torch.bfloat16,)):
            out[(dh, dtype)] = long_times(fb, fa, card, dev,
                                          [(label, b, s, heads) for label, b, s in GL_TIME_SHAPES],
                                          dtype, dh)
            gc.collect()
            torch.cuda.empty_cache()
    return out


# the general route's wgmma kernels, which must not spill
GL_WGMMA_KERNELS = ("gl_fwd_kernel", "gl_core_kernel", "gl_flash_rows_kernel",
                    "gl_flash_cols_kernel")


def no_spill(tag, line) -> None:
    """`line` of ptxas_report for a kernel of GL_WGMMA_KERNELS: no spill
    stores."""
    if line.split("<")[0] in GL_WGMMA_KERNELS and ", 0 B spill stores" not in line:
        raise AssertionError(f"{tag}: {line} spills")


def gl_ptxas(libs) -> None:
    """The registers, spill stores and static shared memory of the new
    kernels' instantiations, and any ptxas line on their wgmma; the wgmma
    kernels must not spill."""
    for name, lib in libs.items():
        text = open(f"{lib}.log").read()
        for line in ptxas_report(text, None, head_dims=True):
            if line.split("<")[0] in GL_NEW_KERNELS:
                log(f"[gl-build] {name}: {line}")
                no_spill(name, line)
        for line in text.splitlines():
            if "wgmma" in line and "gl_" in line:
                log(f"[gl-build] {name}: ptxas: {line.strip()[:240]}")


def general_long_path(fb, fa, card, dev, libs=None) -> list:
    """Phase 19: (b)'s trace, (a) the kernels against their twins and the
    wrappers, (c) the main path, (d) the times. Returns one `kernels` entry
    per new route and head_dim (bf16 at 16, 32, 48; fp32 at 32), `launches`
    from (c) at that head_dim and dtype; a route of the path that (c) never
    launched fails the phase."""
    t_phase = time.perf_counter()
    if libs:
        gl_ptxas(libs)
    gl_trace(fb, fa, dev)
    hd_cuda_counts(fb, fa, GL_HD64_GEOMS)
    log(f"[gl] (b) in {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    errs = gl_kernels(fb, fa, dev)
    log(f"[gl] (a) the kernels alone in {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    layer_errs = hd_kernels(fb, fa, dev, GL_GEOMS + GL_HD64_GEOMS, GL_LAYER_SHAPES,
                            GL_MAIN_SHAPES, seed=SEED + 195)
    gl_limit(fb, dev)
    log(f"[gl] (a) the wrappers and the limit in {time.perf_counter() - t1:.1f} s: largest "
        f"absolute differences from the twins "
        f"{ {f'{k_} hd{dh} {dt}': round(e, 6) for (k_, dh, dt), e in errs.items()} }, through "
        f"the wrappers "
        f"{ {f'{k_} hd{dh} {dt}': round(e, 6) for (k_, dh, dt), e in layer_errs.items()} }")
    t0 = time.perf_counter()
    launches = gl_main_path(card)
    log(f"[gl] (c) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    times = gl_times(fb, fa, card, dev)
    hd64 = gl_hd64_ms(fb, fa, dev)
    log(f"[gl] (d) in {time.perf_counter() - t0:.1f} s; phase 19 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    entries = []
    for (dh, dtype), tm in times.items():
        fp32 = dtype == torch.float32
        dt, heads = ("fp32" if fp32 else "bf16"), dict(GL_TIME_HEADS)[dh]
        for route, replaces in LONG_ROUTES:
            k_ms, p_ms, l_ms, b_ms, b_by, same_ms = tm[route]["384 px"]
            entries.append({
                "name": f"{route} ({'fp32, ' if fp32 else ''}S>256, hd {dh})", "route": "cuda",
                "source": ("vit2spn_tpu_torch/csrc/flash_f32.cuh" if fp32
                           else "vit2spn_tpu_torch/csrc/general_long.cuh"),
                "replaces": replaces,
                "launches": launches.get((dh, str(dtype)[6:]), {}).get(f"{route} (S>256)", 0),
                "max_abs_err": errs[(route, dh, dt)], "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": l_ms,
                "dtype": str(dtype)[6:], "shape": f"B={LONG_MICRO} S=577 D=192 heads={heads}",
                "head_dim_64_ms": hd64[(route, "384 px", dtype)],
                "at_256px": {k_: v_ for k_, v_ in zip(
                    ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                     "same_fn_library_ms"), tm[route]["256 px"]) if v_ is not None},
            })
            entries[-1]["at_256px"]["head_dim_64_ms"] = hd64[(route, "256 px", dtype)]
            if same_ms is not None:
                entries[-1]["same_fn_library_ms"] = same_ms
            if not entries[-1]["launches"]:
                raise AssertionError(f"{entries[-1]['name']} was never launched on the main "
                                     "path")
    return entries


def general_long_in_child() -> list:
    """Phase 19 in a process of its own (`chip_smoke.py --general-long`, the
    kernels already built on disk), as phase 18: late in this process a
    torch.profiler trace drops device kernels, and (b) counts them. Its
    lines are logged here but its last two: its `kernels` line, whose
    entries this returns, and its `ok` line."""
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--general-long",
                           ft_stand_ins()], capture_output=True, text=True,
                          timeout=GL_CHILD_TIMEOUT)
    lines = proc.stdout.splitlines()
    for line in lines[:-2] if proc.returncode == 0 else lines:
        log(line)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0 or len(lines) < 2:
        raise AssertionError(f"chip_smoke.py --general-long exited with {proc.returncode}")
    return json.loads(lines[-2])["kernels"]


# ---------------------------------------------------------------------------
# Phase 20: ViT-Huge/14 (Dosovitskiy et al. 2021, Table 1: 32 layers, D
# 1280, mlp 5120, 16 heads of 80, 632M parameters; HF
# google/vit-huge-patch14-224-in21k; at 224 px with patch 14, S = 257) at
# full width, through the dotted overrides. Head_dim 80 has no register-row
# attention kernels: the bf16 attention runs csrc/general_long.cuh's streamed
# kernels at every S (gl_fwd_kernel<80, *>, gl_core_kernel<80>,
# gl_flash_rows_kernel<80> / _cols_kernel<80>), the fp32 attention
# csrc/flash_f32.cuh's multi-pass route on DH 80; the LayerNorm rows keep 40
# values a lane (csrc/common.cuh LN_PL_HUGE); every GEMM is common.cuh's
# mma.sync (the general route). In a process of its own (`chip_smoke.py
# --vit-huge`), after phase 19 and before phase 13:
# (a) the new kernels' ptxas registers and spills; the trace of gl_trace at
# D 1280, 16 heads, B = 2, S = 257 (every wrapper in bf16 and fp32 runs its
# route's kernels and no other, STAGE_CALLS times the predicted launches;
# one call raises its counter and its long route's by one; two backward
# runs equal); at VH_SHAPES (a ragged B at S = 17, the training shape B =
# 64 at S = 257) and the serving shape (forward only): backbone_fwd at 32
# layers against its twin (VH_FWD_REL_TOL) and as close to fp32 as the
# twin, layer_fwd, mlp_bwd, attn_bwd, merged_bwd (equal to the split pair
# bit for bit) against their twins, at the training shape also as close to
# fp32 as the twins, 32 fused_block calls equal to one fused_backbone, the
# C entries' CUDA launches as predicted, two runs of every backward equal;
# at both VH_SHAPES the flash pair at head_dim 80, bf16 and fp32, against
# its twins and float64 (at S = 17 a ragged B at an S <= 256 off a
# multiple of 64: the bf16 backward's workspace edge), at the training
# shape fp32 (the four layer kernels) against their fp32 twins and
# float64; the head_dim-80 attention kernels alone at VH_LONG (S = 577,
# 1,024) in bf16 and fp32 (gl_check_shape); the core's S limit at head_dim
# 80 (11,072) held at its edge; D = 1280 as 20 heads of 64 (the fast route
# at the widest LayerNorm row), 2 layers; head_dim 96 and D = 1312 refused
# by the C entries and geometry_route.
# (b) `ssp-scratch` with VH_OVERRIDES, bf16, 2 x 64 images a step,
# VH_TRAIN_LAYERS deep on one trainer: step 1 of "fused" against "xla" and
# fp32 "xla" (zoo_step_check), then fits through "fused", merged,
# "fused_layer", "pallas", and one fp32 step of "fused" and of "pallas",
# every counter as predicted, each path's peak device memory; the "fused" step's wall, device
# time by wrapper and card idle. (c) extract at batch 256 through "fused"
# against the plain path. (d) the times: zoo_times at S = 257 (the 32-layer
# forward at B = 256, the layer kernels at B = 64), the flash pair at B = 64
# beside SDPA (bf16, and on fp32 copies), and the attention stage and core
# alone at VH_ATT_TIMES beside their twins, SDPA (its backward) and their
# bounds. `python3 chip_smoke.py --vit-huge` runs the build and this phase
# alone.
VH_LABEL, VH_D, VH_HEADS, VH_MLP, VH_LAYERS = "ViT-Huge/14", 1280, 16, 5120, 32
VH_OVERRIDES = ("vit.hidden_size=1280", "vit.num_heads=16", "vit.mlp_dim=5120",
                "vit.num_layers=32", "vit.patch_size=14")
VH_S, VH_MICRO, VH_ACCUM = 257, 64, 2
VH_SHAPES = ((3, 17, True), (VH_MICRO, VH_S, False))  # (B, S, fast gelu)
VH_SERVE = (BATCH, VH_S, True)
# The 32-layer forward against its twin, relative to the twin's largest
# magnitude: ZOO_FWD_REL_TOL, set at 12 layers, scaled by 32 / 12 (rounded
# up) for the depth, as VL_FWD_REL_TOL scales it for 24; the kernel must
# also be as close to fp32 as the twin (KERNEL_VS_FP32_RATIO) at every shape
VH_FWD_REL_TOL = (5.4e-2, 5.4e-3)
VH_LONG = ((2, 577), (1, 1024))  # (B, S) of the attention kernels alone
VH_ATT_TIMES = ((64, 257), (64, 577))  # (B, S) of (d)'s stage and core alone
VH_FAST_WIDE = ("D=1280 20 heads of 64", 1280, 20, 5120, 3, 197)
# refused: head_dim 96 (only the head_dim bounds it) and D = 1312 (41 heads
# of 32: only the LayerNorm row bounds it), with geometry_route's reason
VH_REFUSED = (("head_dim 96", 768, 8, 3072, "head_dim in"),
              ("D=1312", 1312, 41, 5248, f"D <= {1280}"))
# (b) trains 8 of the 32 layers: at 32 the step-1 check's copies of the
# 632M-parameter state (Adam's moments, three paths' updates) filled the
# 80 GB card, and its host init alone took 29.5 s (H100 80GB HBM3 host);
# every kernel and route of the step is the same at 8 layers. (c) serves
# the full 32 layers from a trainer of its own.
VH_TRAIN_LAYERS = 8
VH_EXTRACT = 256  # one batch a stream (cut from 512 for the script's time)
VH_CHILD_TIMEOUT = 900  # s
VH_NEW_KERNELS = GL_NEW_KERNELS + ("layernorm_kernel", "ln_bwd_kernel")
# the route each wrapper runs at D 1280, 16 heads (head_dim 80): the general
# route's sequences (the MLP half too, D 1280 having no kit route), the
# streamed attention kernels at every S
VH_ROUTE_KERNELS = dict(GL_ROUTE_KERNELS)
VH_ROUTE_KERNELS[("mlp_bwd", 0)] = HD_SEQ_BWD | {"gemm_kernel"}
VH_ROUTE_KERNELS[("merged_bwd", 0)] = (VH_ROUTE_KERNELS[("mlp_bwd", 0)]
                                       | VH_ROUTE_KERNELS[("attn_bwd", 0)])


def vh_ptxas(libs) -> None:
    """The registers and spill stores of the head_dim-80 instantiations and
    of the LayerNorm kernels at 40 values a lane."""
    for name, lib in libs.items():
        text = open(f"{lib}.log").read()
        for line in ptxas_report(text, None, head_dims=True):
            if line.split("<")[0] in GL_NEW_KERNELS and "<80" in line:
                log(f"[vh-build] {name}: {line}")
                no_spill(name, line)
        for line in ptxas_report(text, None):
            if line.split("<")[0] in ("layernorm_kernel", "ln_bwd_kernel"):
                log(f"[vh-build] {name}: {line}")


def vh_counted_twice(fb, name, fn, n_cuda, want) -> None:
    """Two runs of wrapper `name` equal bit for bit, one call raising its
    counter by one, and its C entry's CUDA launches `n_cuda` as predicted."""
    runs = [tensors_of(fn()) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*runs))
    del runs
    reset_launches()
    fn()
    torch.cuda.synchronize()
    counts = {k: n for k, n in read_launches().items() if n and not k.endswith("(S>256)")}
    log(f"[vh] {name}: two runs bitwise equal {same}; one call counted {counts}; {n_cuda} CUDA "
        f"launches (predicted {want})")
    if not same or counts != {name: 1} or n_cuda != want:
        raise AssertionError(f"{name} at ViT-Huge: equal {same}, counted {counts}, "
                             f"{n_cuda} CUDA launches (predicted {want})")


def vh_kernels(fb, fa, dev, wt) -> dict:
    """Phase 20 (a) at D 1280, 16 heads, mlp 5120, on the 32 layers `wt`.
    Returns {kernel: largest absolute difference from the twin} (bf16; fp32
    under "<kernel> (fp32)")."""
    eps, d, heads, mlp = 1e-12, VH_D, VH_HEADS, VH_MLP
    gen = torch.Generator().manual_seed(SEED + 20)
    w0 = tuple(t[0] for t in wt)
    w = layer_weights(fb.WEIGHT_NAMES, wt)
    errs = {}

    def note(k, e):
        errs[k] = max(errs.get(k, 0.0), e)

    for b, s, fast in VH_SHAPES + (VH_SERVE,):
        t0 = time.perf_counter()
        x, x2, g = (torch.randn(b, s, d, generator=gen) for _ in range(3))
        x, x2, g = (t.to(torch.bfloat16).to(dev) for t in (x, x2, 0.1 * g))
        tag = f"{VH_LABEL} B={b} S={s} fast_gelu={fast}"
        note("backbone_fwd", check_backbone_fwd(tag, fb, x, wt, heads, eps, fast,
                                                VH_FWD_REL_TOL))
        if (b, s, fast) == VH_SERVE:
            log(f"[vh] (a) {tag}: {time.perf_counter() - t0:.1f} s")
            break
        train = b == VH_MICRO
        note("layer_fwd", check_layer_fwd(tag, fb, x, w0, heads, eps, fast, train))
        for k, v in check_layer_bwd(tag, fb, x, g, w, heads, eps, fast,
                                    against_fp32=train).items():
            note(k, v)
        note("merged_bwd", check_merged_bwd(tag, fb, x, x2, g, w, heads, eps, fast, True))
        # the flash pair at head_dim 80, bf16 and fp32; at B = 3, S = 17 too:
        # a ragged B at an S <= 256 off a multiple of 64, where the bf16
        # backward's workspace (3 x 64 floats a 64-query chunk) ends
        q, k, v, do = flash_operands(gen, b, s, heads, torch.bfloat16, dev, d // heads)
        for name, e in check_flash(f"{VH_LABEL} B={b} S={s}", q, k, v, do).items():
            note(name, e)
            vh_counted_twice(fb, name, (lambda: fa.flash_fwd(q, k, v)) if name == "flash_fwd"
                             else (lambda: fa.flash_bwd(q, k, v, do)),
                             fb.cuda_launches(name, fa.KERNEL_NAME),
                             hd_predicted_launches(name, d, heads, mlp, 0))
        for name, e in check_flash(f"{VH_LABEL} fp32 B={b} S={s}",
                                   *(t.float() for t in (q, k, v, do))).items():
            note(f"{name} (fp32)", e)
        del q, k, v, do
        if not train:
            log(f"[vh] (a) {tag}: {time.perf_counter() - t0:.1f} s")
            continue
        with torch.no_grad():
            h = x
            for l in range(VH_LAYERS):
                h = fb.fused_block(h, tuple(t[l] for t in wt), heads, eps, fast)
            share = equal_bits(h, fb.fused_backbone(x, wt, heads, eps, fast))
        log(f"[vh] {tag}: {VH_LAYERS} fused_block calls vs one fused_backbone: "
            f"{100.0 * share:.4f}% of the outputs equal bit for bit (must be 100%)")
        if share != 1.0:
            raise AssertionError("the per-layer forward differs from the backbone at D=1280")
        del h
        calls = {"backbone_fwd": lambda: fb.fused_backbone(x, wt, heads, eps, fast, True),
                 "layer_fwd": lambda: fb.layer_fwd(x, w0, heads, eps, fast),
                 "mlp_bwd": lambda: fb.mlp_bwd(x2, g, w, eps, fast),
                 "attn_bwd": lambda: fb.attn_bwd(x, g, w, heads, eps),
                 "merged_bwd": lambda: fb.merged_bwd(x, x2, g, w, heads, eps, fast)}
        for name, fn in calls.items():
            n_cuda = (VH_LAYERS * fb.kernel_launches_per_layer(d, False, heads, mlp)
                      if name == "backbone_fwd"
                      else fb.cuda_launches(name, None, d, 0, heads=heads, mlp=mlp))
            want = hd_predicted_launches(name, d, heads, mlp, 0) * (
                VH_LAYERS if name == "backbone_fwd" else 1)
            vh_counted_twice(fb, name, fn, n_cuda, want)
        for k_, e in check_fp32_layer(f"{VH_LABEL} fp32 B={b} S={s}", fb, x.float(),
                                      x2.float(), g.float(), w, heads, eps, fast).items():
            note(f"{k_} (fp32)", e)
        log(f"[vh] (a) {tag}: {time.perf_counter() - t0:.1f} s")
    del w0, w, x, x2, g
    gc.collect()
    torch.cuda.empty_cache()
    return errs


def vh_long(fb, fa, dev) -> dict:
    """Phase 20 (a): the head_dim-80 attention kernels alone at D 1280, 16
    heads, at VH_LONG, bf16 and fp32 (gl_check_shape). Returns {(route,
    80, dtype): largest absolute difference from the twin}."""
    errs = {}

    def note(route, dh, dt, e):
        errs[(route, dh, dt)] = max(errs.get((route, dh, dt), 0.0), e)

    gen = torch.Generator().manual_seed(SEED + 201)
    for b, s in VH_LONG:
        for dtype in (torch.bfloat16, torch.float32):
            gl_check_shape(fb, fa, dev, gen, VH_LABEL, VH_D, VH_HEADS, b, s, dtype, note)
    return errs


def vh_limit(fb, dev) -> None:
    """Phase 20 (a): the bf16 core's S limit at head_dim 80 as the C entry
    and ops/fused_block.py state it; the core at that S (D 160, 2 heads)
    against its twin; one query past it refused by the C entry (no launch)
    and by the wrappers' check."""
    lib = fb._load("attn_bwd")
    limit, d, heads = lib.vit2spn_attention_core_max_seq(80), 160, 2
    if limit != fb.attention_core_max_seq(80):
        raise AssertionError(f"the core's S limit at head_dim 80 is {limit}, "
                             f"ops/fused_block.py says {fb.attention_core_max_seq(80)}")
    gen = torch.Generator().manual_seed(SEED + 202)
    qkv = (0.5 * torch.randn(1, limit, 3 * d, generator=gen)).to(torch.bfloat16).to(dev)
    datt = (0.1 * torch.randn(1, limit, d, generator=gen)).to(torch.bfloat16).to(dev)
    t0 = time.perf_counter()
    got = attention_core_call(fb, qkv, datt, heads)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    thirds = lambda t: (t[0], *t[1].split(d, dim=-1))  # noqa: E731
    check_rel(f"core at its longest S={limit}, head_dim 80 ({secs:.2f} s)",
              ("att", "dq", "dk", "dv"), thirds(got),
              thirds(fb._attention_bwd(qkv, datt, heads)),
              thirds(fb._attention_bwd(qkv.float(), datt.float(), heads)), "vh")
    del qkv, datt, got
    torch.cuda.empty_cache()
    over = torch.zeros(1, limit + 1, 3 * d, dtype=torch.bfloat16, device=dev)
    x = torch.zeros(1, limit + 1, d, dtype=torch.bfloat16, device=dev)
    rc = lib.vit2spn_attention_core(over.data_ptr(), x.data_ptr(), x.data_ptr(), over.data_ptr(),
                                    1, limit + 1, heads, d, fb._stream(dev))
    try:
        fb._check_layer_inputs(x, x, {}, fb.ATTN_NAMES, heads, {})
        raised = ""
    except ValueError as e:
        raised = str(e)
    log(f"[vh-limit] head_dim 80: the core takes S <= {limit}; at S={limit + 1} the C entry "
        f"returns {rc} without a launch and the wrappers' check raises: {raised}")
    if rc == 0 or f"S <= {limit}" not in raised:
        raise AssertionError(f"S = {limit + 1} at head_dim 80 was not refused (rc {rc}, check "
                             f"{raised!r})")
    del over, x
    torch.cuda.empty_cache()


def vh_fast_wide(fb, dev) -> None:
    """Phase 20 (a): D 1280 as 20 heads of 64 (the fast route: the forward's
    seven launches on tile_gemm.cuh, the backward's mma.sync sequences, at
    the widest LayerNorm row), 2 layers, against the twins."""
    label, d, heads, mlp, b, s = VH_FAST_WIDE
    eps = 1e-12
    if fb.geometry_route(d, heads, mlp, s) != (fb.ROUTE_FAST, ""):
        raise AssertionError(f"{label} does not take the fast route")
    gen = torch.Generator().manual_seed(SEED + 203)
    wt = random_backbone(gen, 2, d, mlp, dev)
    w = layer_weights(fb.WEIGHT_NAMES, wt)
    x, x2, g = (torch.randn(b, s, d, generator=gen) for _ in range(3))
    x, x2, g = (t.to(torch.bfloat16).to(dev) for t in (x, x2, 0.1 * g))
    tag = f"{label} mlp={mlp} B={b} S={s}"
    check_backbone_fwd(tag, fb, x, wt, heads, eps, True)
    check_layer_bwd(tag, fb, x, g, w, heads, eps, True, against_fp32=True)
    check_merged_bwd(tag, fb, x, x2, g, w, heads, eps, True, True)
    del wt, w, x, x2, g
    torch.cuda.empty_cache()


def vh_refused(fb, dev) -> None:
    """Phase 20 (a): VH_REFUSED returned as errors by every layer kernel's
    C entry (and, for the head_dim, the flash pair's) before any launch, and
    refused by geometry_route with its reason."""
    eps, st = 1e-12, fb._stream(dev)
    for label, d, heads, mlp, reason in VH_REFUSED:
        b, s = 2, 197
        m = b * s
        rcs = {
            "backbone_fwd": fb._load("backbone_fwd").vit2spn_backbone_fwd(
                *[None] * 21, b, s, d, heads, mlp, 1, eps, 1, st),
            "layer_fwd": fb._load("layer_fwd").vit2spn_layer_fwd(
                *[None] * 20, b, s, d, heads, mlp, eps, 1, st),
            "attn_bwd": fb._load("attn_bwd").vit2spn_attn_bwd(*[None] * 21, b, s, d, heads, eps,
                                                              0, st),
            "merged_bwd": fb._load("merged_bwd").vit2spn_merged_bwd(
                *[None] * 37, b, s, d, heads, mlp, eps, 1, 0, st),
        }
        if d > fb.KERNEL_MAX_D:
            rcs["mlp_bwd"] = fb._load("mlp_bwd").vit2spn_mlp_bwd(*[None] * 19, m, d, mlp, eps,
                                                                 1, 0, st)
        else:
            dh = d // heads
            rcs["flash_fwd"] = fb._load("flash_attention").vit2spn_flash_fwd(
                *[None] * 4, b, s, heads, dh, s * 3 * d, 3 * d, 0, st)
        torch.cuda.synchronize()
        route, why = fb.geometry_route(d, heads, mlp, s)
        log(f"[vh] {label} (D={d}, {heads} heads of {d // heads}, mlp {mlp}): the C entries "
            f"return {rcs}; geometry_route: {route}, {why!r}")
        if not all(rcs.values()) or route is not None or reason not in why:
            raise AssertionError(f"{label} was not refused ({rcs}, {route}, {why!r})")


def vh_card_backbone(vit, seed) -> dict:
    """A ViT backbone of `vit`'s shape drawn on the card from `seed`: the
    block matrices normal with std 0.02 (as random_backbone's), LN 1 and 0,
    biases 0, the rest as init_vit draws it at one layer. (c)'s trainer
    takes it as its backbone (the pretrained path's `backbone_params`):
    its own init draws every net's truncated normals on the host, 27-30 s
    at 32 layers on the H100 80GB HBM3's host)."""
    from vit2spn_tpu_torch.core.config import replace
    from vit2spn_tpu_torch.models.vit import init_vit

    p = init_vit(torch.Generator().manual_seed(seed), replace(vit, num_layers=1), device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for name, t in p["blocks"].items():
        shape = (vit.num_layers, *t.shape[1:])
        p["blocks"][name] = (0.02 * torch.randn(shape, generator=gen, device="cuda")
                             if name in ("wqkv", "wo", "w1", "w2")
                             else t.expand(shape).contiguous())
    return p


def vh_training(card) -> dict:
    """Phase 20 (b) on one SSPTrainer of `ssp-scratch` with the ViT-Huge/14
    overrides, VH_TRAIN_LAYERS deep: step 1 (zoo_step_check);
    `fit` through "fused" (two steps), merged, "fused_layer", "pallas", fp32
    "fused" and fp32 "pallas" (one step each), every counter as predicted, each path's
    peak device memory; the "fused" step's wall, device time by wrapper and
    card idle; then (c) on a trainer of all 32 layers, extract of
    VH_EXTRACT images at batch 256 through "fused" against the plain path.
    Returns the launches of (b)'s runs by kernel (fp32 under "<kernel>
    (fp32)")."""
    from vit2spn_tpu_torch.cli import _apply_overrides
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops.fused_block import KERNEL_NAME
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    over = [*VH_OVERRIDES, f"batch_size={VH_MICRO}", f"accumulation_steps={VH_ACCUM}"]
    if VH_TRAIN_LAYERS != VH_LAYERS:
        over.append(f"vit.num_layers={VH_TRAIN_LAYERS}")
    cfg = _apply_overrides(get_preset("ssp-scratch"), over)
    vit = cfg.vit
    geom = (vit.hidden_size, vit.num_heads, vit.head_dim, vit.mlp_dim, vit.num_layers,
            vit.image_size, vit.patch_size, vit.seq_len, cfg.compute_dtype)
    if geom != (VH_D, VH_HEADS, 80, VH_MLP, VH_TRAIN_LAYERS, 224, 14, VH_S, "bfloat16"):
        raise AssertionError(f"the ViT-Huge/14 overrides gave {geom}")
    eff, a, layers = cfg.effective_batch, cfg.accumulation_steps, vit.num_layers
    t0 = time.perf_counter()
    tr = SSPTrainer(cfg, logger=MetricLogger(echo=False), attn_impl="fused", device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in flat_tensors(tr.params.online).values()) // 2
    log(f"[vh] (b) {VH_LABEL} SSP: D={VH_D}, {VH_HEADS} heads of 80, mlp {VH_MLP}, {layers} "
        f"layers{'' if layers == VH_LAYERS else f' (cut from {VH_LAYERS})'}, S={vit.seq_len}, "
        f"{a} x {cfg.batch_size} (cut from 8 x 128), bf16; one trainer, {n_params} params a "
        f"backbone, built in {time.perf_counter() - t0:.1f} s")
    tds = synthetic_dataset(split_sizes={"train": 2 * eff}, image_size=28,
                            seed=SEED + 20).split("train")
    t0 = time.perf_counter()
    zoo_step_check(tr, cfg, tds.images[:eff], VH_LABEL)
    log(f"[vh] (b) step 1 checks in {time.perf_counter() - t0:.1f} s")
    long_fwd, long_bwd = 2 * 2 * a * layers, 2 * a * layers
    fwd = {KERNEL_NAME: 2 * 2 * a, "attention_fwd (S>256)": long_fwd}
    split = {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers,
             "attention_bwd (S>256)": long_bwd}
    merged = {"merged_bwd": 2 * a * layers, "attention_bwd (S>256)": long_bwd}
    layer = {"layer_fwd": long_fwd, "attention_fwd (S>256)": long_fwd, **split}
    flash = {"flash_fwd": long_fwd, "flash_bwd": long_bwd, "flash_fwd (S>256)": long_fwd,
             "flash_bwd (S>256)": long_bwd}
    one = tds.subset(np.arange(eff))
    total = {}
    for impl, merged_bwd, fp32, images, per_step in (
            ("fused", False, False, tds, {**fwd, **split}),
            ("fused", True, False, one, {**fwd, **merged}),
            ("fused_layer", False, False, one, layer),
            ("pallas", False, False, one, flash),
            ("fused", False, True, one, {**fwd, **split}),
            ("pallas", False, True, one, flash)):
        pcfg = replace_cfg(cfg, compute_dtype="float32") if fp32 else cfg
        use_path(tr, pcfg, impl)
        torch.cuda.reset_peak_memory_stats()
        _, n, _ = fit_path(pcfg, images, impl, merged_bwd, per_step, trainer=tr)
        log(f"[vh] (b) {path_name(impl, merged_bwd, pcfg)}: peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB on {card}")
        for k_, v_ in n.items():
            key = f"{k_} (fp32)" if fp32 else k_
            total[key] = total.get(key, 0) + v_
        if impl == "fused" and not (merged_bwd or fp32):  # the step's time by wrapper
            totals = {}
            wrappers = (KERNEL_NAME, "mlp_bwd", "attn_bwd")
            step_s = time_steps(tr, eff, f"fused {VH_LABEL}", card, wrappers,
                                "views, embed, heads, loss, Adam, EMA", reps=2, totals=totals)
            device = totals.get("device", float("nan"))
            by = {w_: totals.get(f"vit2spn::{w_}", float("nan")) for w_ in wrappers}
            log(f"[vh] (b) fused {VH_LABEL} step ({eff} images, {layers} layers): wall "
                f"{1e3 * step_s:.2f} ms, {eff / step_s:.1f} img/s, device {device:.3f} ms "
                f"({', '.join(f'{w_} {ms:.3f}' for w_, ms in by.items())}, the rest "
                f"{device - sum(by.values()):.3f}), card idle "
                f"{100 * (1 - device / (1e3 * step_s)):.1f}% on {card}")
        os.environ["VIT2SPN_MERGED_BWD"] = "0"
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    # (c) extract through "fused" at all 32 layers, against the plain path
    cfg = _apply_overrides(get_preset("ssp-scratch"), list(VH_OVERRIDES))
    layers = cfg.vit.num_layers
    t0 = time.perf_counter()
    tr = SSPTrainer(cfg, backbone_params=vh_card_backbone(cfg.vit, SEED + 205),
                    logger=MetricLogger(echo=False), attn_impl="fused", device="cuda")
    torch.cuda.synchronize()
    log(f"[vh] (c) a {layers}-layer trainer built in {time.perf_counter() - t0:.1f} s (its "
        f"backbone drawn on the card, init {tr.init_provenance!r})")
    ds = synthetic_dataset(split_sizes={"all": VH_EXTRACT}, image_size=28, seed=SEED)
    tr.extract_features(ds, batch_size=BATCH)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    feats, _ = tr.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = {k_: n_ for k_, n_ in read_launches().items() if n_}
    calls = 2 * -(-VH_EXTRACT // BATCH)  # dual stream
    want = {KERNEL_NAME: calls, "attention_fwd (S>256)": calls * layers}
    totals = {}
    lines = stage_breakdown(lambda: tr.extract_features(ds, batch_size=BATCH),
                            f"{VH_LABEL} extract of {len(ds)} images", top=6,
                            wrappers=(KERNEL_NAME,), rest="views, embed, heads", totals=totals)
    tr.attn_impl = "plain"
    plain, _ = tr.extract_features(ds, batch_size=BATCH)
    scale, err = float(np.abs(plain).max()), float(np.abs(feats - plain).max())
    log(f"[vh] (c) {VH_LABEL} extract at batch {BATCH}, {layers} layers: {feats.shape} features "
        f"in {secs:.3f} s, {len(ds) / secs:.1f} img/s, launches {launches} (want {want}); "
        f"forward device {totals.get('vit2spn::' + KERNEL_NAME, float('nan')):.3f} ms of "
        f"{totals.get('device', float('nan')):.3f} ms; vs plain max_abs_err {err:.6g} (max "
        f"|plain| {scale:.4g}, tol {FEATURE_REL_TOL} relative) on {card}")
    for line in lines:
        log(line)
    if launches != want:
        raise AssertionError(f"{VH_LABEL} extract launched {launches}, not {want}")
    if feats.shape != (len(ds), cfg.proj_dim) or not np.isfinite(feats).all():
        raise AssertionError(f"{VH_LABEL} extract: bad features {feats.shape}")
    if not err <= FEATURE_REL_TOL * scale:
        raise AssertionError(f"{VH_LABEL} features disagree with the plain path")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return total


def vh_flash_times(fb, fa, card, dev, launches, errs) -> list:
    """Phase 20 (d) for the flash pair at head_dim 80, B = 64, S = 257, 16
    heads: kernel, twin, bf16 SDPA (its backward), SDPA on fp32 copies (the
    same function) and the bound; then the fp32 route on fp32 copies beside
    fp32 SDPA."""
    gen = torch.Generator().manual_seed(SEED + 204)
    b, s, heads, dh = VH_MICRO, VH_S, VH_HEADS, VH_D // VH_HEADS
    entries = []
    for dtype in (torch.bfloat16, torch.float32):
        fp32 = dtype == torch.float32
        q, k, v, do = flash_operands(gen, b, s, heads, dtype, dev, dh)
        lib_bwd, _ = library_flash_bwd(q, k, v, do)
        same = check_same_fn_yardstick(q, k, v, do) if not fp32 else (None, None)
        for (name, replaces, kind, kernel, twin, library), same_fn in zip((
                ("flash_fwd", "vit2spn_tpu/ops/flash_attention.py:36", "fwd",
                 lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
                 lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v)))),
                ("flash_bwd", "vit2spn_tpu/ops/flash_attention.py:53", "bwd",
                 lambda: fa.flash_bwd(q, k, v, do),
                 lambda: fa.flash_attention_bwd_plain(q, k, v, do), lib_bwd)), same):
            b_ms, b_by, b_flops = flash_bound_ms(kind, b, s, heads, fp32, dh)
            k_ms = time_ms(kernel)
            p_ms = time_ms(twin, iters=5, warmup=1)
            with torch.no_grad() if kind == "fwd" else torch.enable_grad():
                l_ms = time_ms(library)
                s_ms = time_ms(same_fn) if same_fn else None
            n_cuda = fb.cuda_launches(name, fa.KERNEL_NAME)
            key = f"{name} (fp32)" if fp32 else name
            log(f"[vh-time] {VH_LABEL} {key} B={b} S={s} heads={heads} head_dim {dh}: kernel "
                f"{k_ms:.4f} ms ({n_cuda} CUDA launches), plain twin {p_ms:.3f} ms, "
                f"{'fp32' if fp32 else 'bf16'} SDPA {l_ms:.4f} ms"
                + (f", SDPA on fp32 copies (same fn) {s_ms:.4f} ms" if s_ms else "")
                + f", bound {b_ms:.4f} ms ({b_by}; {b_flops / 1e9:.2f} GFLOP), kernel at "
                f"{b_flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, {100 * b_ms / k_ms:.1f}% of the "
                f"bound; {card}")
            entries.append({
                "name": f"{key} (hd 80, D={VH_D})", "route": "cuda",
                "source": ("vit2spn_tpu_torch/csrc/flash_f32.cuh" if fp32
                           else "vit2spn_tpu_torch/csrc/general_long.cuh"),
                "replaces": replaces, "launches": launches.get(key, 0),
                "max_abs_err": errs.get(key), "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                "bound_by": b_by, "library_ms": l_ms, "library_same_fn_ms": s_ms,
                "cuda_launches": n_cuda, "dtype": str(dtype)[6:],
            })
        del q, k, v, do, lib_bwd, same
        torch.cuda.empty_cache()
    return entries


def vh_attention_times(fb, fa, card, dev, launches, errs) -> list:
    """Phase 20 (d) for the attention stage and core alone at head_dim 80
    (D 1280, 16 heads) at VH_ATT_TIMES: kernel (CUDA events), twin, bf16
    SDPA (its backward for the core) and the bound, and the flash forward
    beside them. Returns the stage's and the core's `kernels` entries at the
    first shape, the second under "at_<S>"."""
    heads, dh = VH_HEADS, VH_D // VH_HEADS
    entries = {}
    for b, s in VH_ATT_TIMES:
        gen = torch.Generator().manual_seed(SEED + 206 + s)
        qkv = torch.randn(b, s, 3 * VH_D, generator=gen).to(torch.bfloat16).to(dev)
        datt = (0.1 * torch.randn(b, s, VH_D, generator=gen)).to(torch.bfloat16).to(dev)
        q, k, v = (t.reshape(b, s, heads, dh) for t in qkv.split(VH_D, dim=-1))
        do = datt.reshape(b, s, heads, dh)
        sdpa_in = [t.transpose(1, 2) for t in (q, k, v)]
        sdpa_bwd, _ = library_flash_bwd(q, k, v, do)
        for route, replaces, kernel, twin, library in (
                ("attention_fwd", "vit2spn_tpu/ops/fused_block.py:694",
                 lambda: attention_stage_call(fb, qkv, heads),
                 lambda: attention_stage_plain(qkv, heads),
                 lambda: F.scaled_dot_product_attention(*sdpa_in)),
                ("attention_bwd", "vit2spn_tpu/ops/fused_block.py:357",
                 lambda: attention_core_call(fb, qkv, datt, heads),
                 lambda: fb._attention_bwd(qkv, datt, heads), sdpa_bwd),
                ("flash_fwd", "vit2spn_tpu/ops/flash_attention.py:36",
                 lambda: fa.flash_fwd(q, k, v), lambda: fa.flash_attention_plain(q, k, v),
                 lambda: F.scaled_dot_product_attention(*sdpa_in))):
            k_ms = time_ms(kernel, iters=10, warmup=2)
            p_ms = time_ms(twin, iters=3, warmup=1)
            with torch.no_grad() if route.endswith("fwd") else torch.enable_grad():
                l_ms = time_ms(library, iters=10, warmup=2)
            b_ms, b_by, flops = long_bound_ms(route, b, s, heads, False, dh)
            log(f"[vh-time] {VH_LABEL} {route} alone B={b} S={s} heads={heads} head_dim {dh}: "
                f"kernel {k_ms:.4f} ms, plain twin {p_ms:.3f} ms, bf16 SDPA"
                f"{' backward' if route.endswith('bwd') else ''} {l_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP), kernel at "
                f"{flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, {100 * b_ms / k_ms:.1f}% of the "
                f"bound; {card}")
            if route == "flash_fwd":  # vh_flash_times holds its entry
                continue
            numbers = {"ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                       "library_ms": l_ms}
            if route not in entries:
                entries[route] = {
                    "name": f"{route} (hd 80, D={VH_D})", "route": "cuda",
                    "source": "vit2spn_tpu_torch/csrc/general_long.cuh", "replaces": replaces,
                    "launches": launches.get(f"{route} (S>256)", 0),
                    "max_abs_err": errs.get((route, dh, "bf16")), **numbers,
                    "dtype": "bfloat16", "shape": f"B={b} S={s} D={VH_D} heads={heads}"}
            else:
                entries[route][f"at_{s}"] = numbers
        del qkv, datt, q, k, v, do, sdpa_in, sdpa_bwd
        torch.cuda.empty_cache()
    return list(entries.values())


def vit_huge_path(fb, fa, card, dev, libs=None) -> list:
    """Phase 20, ViT-Huge/14: (a) the kernels at D 1280 and head_dim 80
    against their twins, (b) SSP training, (c) extract, (d) the times.
    Returns (d)'s {"kernels": [...]} entries, each kernel's `launches` from
    (b); a kernel of the path that (b) never launched fails the phase."""
    t_phase = time.perf_counter()
    if libs:
        vh_ptxas(libs)
    gl_trace(fb, fa, dev, (VH_D, VH_HEADS, VH_MLP, 2, VH_S), VH_ROUTE_KERNELS, SEED + 200, "vh")
    log(f"[vh] (a) the trace in {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    # one draw of the 32 layers for (a) and (d): ~10 s of host RNG each
    wt = random_backbone(torch.Generator().manual_seed(SEED + VH_D), VH_LAYERS, VH_D, VH_MLP,
                         dev)
    errs = vh_kernels(fb, fa, dev, wt)
    log(f"[vh] (a) the wrappers in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    long_errs = vh_long(fb, fa, dev)
    log(f"[vh] (a) the attention kernels at S = {[s for _, s in VH_LONG]} in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vh_limit(fb, dev)
    log(f"[vh] (a) the core's limit in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    vh_fast_wide(fb, dev)
    vh_refused(fb, dev)
    log(f"[vh] (a) the fast route at D 1280 and the refusals in "
        f"{time.perf_counter() - t0:.1f} s; largest absolute differences from the twins "
        f"{ {k: round(e, 6) for k, e in errs.items()} }, the attention kernels alone "
        f"{ {f'{k_} {dt} hd{dh}': round(e, 6) for (k_, dh, dt), e in long_errs.items()} }")
    t0 = time.perf_counter()
    launches = vh_training(card)
    log(f"[vh] (b), (c) in {time.perf_counter() - t0:.1f} s; launches {launches}")
    t0 = time.perf_counter()
    entries = zoo_times(fb, card, dev, {VH_D: launches}, {VH_D: errs},
                        widths=[(VH_LABEL, VH_D, VH_HEADS, VH_MLP, VH_LAYERS)], s=VH_S,
                        b_layer=VH_MICRO, fwd_iters=5, weights=wt)
    del wt
    entries += vh_flash_times(fb, fa, card, dev, launches, errs)
    entries += vh_attention_times(fb, fa, card, dev, launches, long_errs)
    log(f"[vh] (d) in {time.perf_counter() - t0:.1f} s; phase 20 in "
        f"{time.perf_counter() - t_phase:.1f} s")
    for e in entries:
        if not e["launches"]:
            raise AssertionError(f"{e['name']} was never launched on the main path")
    return entries


def vit_huge_in_child() -> list:
    """Phase 20 in a process of its own (`chip_smoke.py --vit-huge`, the
    kernels already built on disk), as phases 18 and 19: its traces count
    device kernels, which a trace late in this process drops. Its lines are
    logged here but its last two: its `kernels` line, whose entries this
    returns, and its `ok` line."""
    gc.collect()
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--vit-huge"],
                          capture_output=True, text=True, timeout=VH_CHILD_TIMEOUT)
    lines = proc.stdout.splitlines()
    for line in lines[:-2] if proc.returncode == 0 else lines:
        log(line)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0 or len(lines) < 2:
        raise AssertionError(f"chip_smoke.py --vit-huge exited with {proc.returncode}")
    return json.loads(lines[-2])["kernels"]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from vit2spn_tpu_torch.core.config import replace
    from vit2spn_tpu_torch.core.presets import get_preset
    from vit2spn_tpu_torch.data.datasets import synthetic_dataset
    from vit2spn_tpu_torch.ops import cuda_build
    from vit2spn_tpu_torch.ops import flash_attention as fa
    from vit2spn_tpu_torch.ops import fused_block as fb
    from vit2spn_tpu_torch.ops.fused_block import (
        KERNEL_NAME,
        backbone_forward_plain,
        fast_gelu_default,
        fused_backbone,
        kernel_launches_per_layer,
    )
    from vit2spn_tpu_torch.train.ssp import SSPTrainer
    from vit2spn_tpu_torch.utils.logging import MetricLogger

    os.environ["VIT2SPN_MERGED_BWD"] = "0"
    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[card] {card}")
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    if sys.argv[1:2] == ["--hd-trace"]:  # phase 17 (b)'s trace, in a process of its own
        hd_trace(fb, fa, dev)
        return 0

    cfg = replace(get_preset("ssp"), pretrained_init=False)
    vit = cfg.vit

    # -- 2. build ------------------------------------------------------------
    t0 = time.perf_counter()
    libs = cuda_build.build_all(fb.KERNEL_NAMES)
    build_s = time.perf_counter() - t0
    log(f"[build] {', '.join(fb.KERNEL_NAMES)} in {build_s:.2f} s (in parallel); each "
        f"source's nvcc, s: {json.dumps(cuda_build.BUILD_SECONDS)}")
    nt = (vit.seq_len + 15) // 16 * 2  # the attention kernels' key tiles at S
    for name, lib in libs.items():
        for line in ptxas_report(open(f"{lib}.log").read(), nt):
            log(f"[build]   {name}: {line}")
    # the forward layer's kernels take their shared memory at launch
    smem = {k: fb.layer_fwd_smem_bytes(vit.seq_len, vit.hidden_size, k)
            for k in ("ln_qkv", "attention", "mlp")}
    log(f"[build]   layer_fwd / backbone_fwd dynamic shared memory per block at S="
        f"{vit.seq_len}, D={vit.hidden_size}: {smem} B")

    if sys.argv[1:2] == ["--zoo-times"]:  # phase 14 (e) alone, for another tree's kernels
        print(json.dumps({"kernels": zoo_times(fb, card, dev)}))
        return 0
    if sys.argv[1:2] == ["--long-seq"]:  # phase 15 alone
        print(json.dumps({"kernels": long_seq_path(fb, fa, card, dev)}))
        return 0
    if sys.argv[1:2] == ["--fp32-long"]:  # phase 16 alone
        print(json.dumps({"kernels": fp32_long_path(fb, fa, card, dev)}))
        return 0
    if sys.argv[1:2] in (["--head-dim"], ["--vit-large"], ["--general-long"],
                         ["--vit-huge"]):  # phases 17, 18, 19, 20
        entries = (head_dim_path(fb, fa, card, dev, libs) if sys.argv[1] == "--head-dim"
                   else vit_large_path(fb, fa, card, dev) if sys.argv[1] == "--vit-large"
                   else vit_huge_path(fb, fa, card, dev, libs) if sys.argv[1] == "--vit-huge"
                   else general_long_path(fb, fa, card, dev, libs))
        print(json.dumps({"kernels": entries}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    # the fine-tune step's wall time before any other phase (phase 10b times
    # it again after them)
    ft_fresh_s = ft_step_wall_fresh()

    # -- 3. forward kernel vs plain twin at the serving shapes -----------------
    layers, d, heads, mlp, s = (vit.num_layers, vit.hidden_size, vit.num_heads,
                                vit.mlp_dim, vit.seq_len)
    eps = vit.layernorm_eps
    gen = torch.Generator().manual_seed(SEED)
    wt = random_backbone(gen, layers, d, mlp, dev)
    x = torch.randn(BATCH, s, d, generator=gen).to(torch.bfloat16).to(dev)
    wt32 = tuple(t.float() for t in wt)
    max_err = 0.0
    for fast in (False, True):
        ref32 = backbone_forward_plain(x.float(), wt32, heads, eps, fast)
        for emit in (False, True):
            got = fused_backbone(x, wt, heads, eps, fast, emit)
            torch.cuda.synchronize()
            ref = backbone_forward_plain(x, wt, heads, eps, fast, emit)
            got = got if emit else (got,)
            ref = ref if emit else (ref,)
            for name, a, b in zip(("out", "xs", "x2s"), got, ref):
                diff = (a.float() - b.float()).abs()
                mx, mean = float(diff.max()), float(diff.mean())
                log(f"[kernel-vs-plain] fast_gelu={fast} emit_res={emit} {name}: "
                    f"max_abs_err {mx:.6g} mean_abs_err {mean:.3g} "
                    f"(max |ref| {float(b.float().abs().max()):.4g}; tol max "
                    f"{KERNEL_MAX_ABS_TOL}, mean {KERNEL_MEAN_ABS_TOL})")
                if not (mx <= KERNEL_MAX_ABS_TOL and mean <= KERNEL_MEAN_ABS_TOL):
                    raise AssertionError(
                        f"kernel disagrees with its plain twin ({name}, "
                        f"fast_gelu={fast}, emit_res={emit})")
                max_err = max(max_err, mx)
            err_k = float((got[0].float() - ref32).abs().mean())
            err_p = float((ref[0].float() - ref32).abs().mean())
            log(f"[kernel-vs-fp32] fast_gelu={fast} emit_res={emit}: mean_abs_err "
                f"kernel {err_k:.6g}, plain twin {err_p:.6g} (tol ratio "
                f"{KERNEL_VS_FP32_RATIO})")
            if not err_k <= KERNEL_VS_FP32_RATIO * err_p:
                raise AssertionError("kernel is less accurate than its plain twin")
        del ref32
    # other shapes the kernel takes: ragged M, S < 16 and S = 256, D = 256
    # (the widest layer kept in one block), the ViT-Small and ViT-Base widths
    # (the seven-launch wide route); 1-2 layers, so the same bounds hold
    for b_, s_, d_, h_, m_, l_ in ((3, 5, 192, 3, 768, 2), (2, 50, 384, 6, 1536, 2),
                                   (1, 256, 192, 3, 768, 1), (5, 17, 768, 12, 3072, 1),
                                   (2, 40, 256, 4, 1024, 1)):
        wt_ = random_backbone(gen, l_, d_, m_, dev)
        x_ = torch.randn(b_, s_, d_, generator=gen).to(torch.bfloat16).to(dev)
        got = fused_backbone(x_, wt_, h_, eps, True).float()
        torch.cuda.synchronize()
        diff = (got - backbone_forward_plain(x_, wt_, h_, eps, True).float()).abs()
        mx, mean = float(diff.max()), float(diff.mean())
        log(f"[kernel-vs-plain] B={b_} S={s_} D={d_} heads={h_} mlp={m_} L={l_}: "
            f"max_abs_err {mx:.6g} mean_abs_err {mean:.3g}")
        if not (mx <= KERNEL_MAX_ABS_TOL and mean <= KERNEL_MEAN_ABS_TOL):
            raise AssertionError(f"kernel disagrees with its plain twin at B={b_} "
                                 f"S={s_} D={d_}")
    lib_out = library_backbone(x, wt, heads, eps)
    plain_out = backbone_forward_plain(x, wt, heads, eps, False)
    log(f"[library-vs-plain] max_abs_err "
        f"{float((lib_out.float() - plain_out.float()).abs().max()):.6g} "
        "(yardstick only; it rounds elsewhere and uses torch's erf gelu)")
    del lib_out, plain_out

    # -- 4. backward kernels vs plain twins ------------------------------------
    wl = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d, mlp, dev))
    xb = torch.randn(TRAIN_BATCH, s, d, generator=gen).to(torch.bfloat16).to(dev)
    gb = (0.1 * torch.randn(TRAIN_BATCH, s, d, generator=gen)).to(torch.bfloat16).to(dev)
    bwd_err = {"mlp_bwd": 0.0, "attn_bwd": 0.0}
    for fast in (False, True):
        errs = check_layer_bwd(f"B={TRAIN_BATCH} S={s} D={d} fast_gelu={fast}", fb, xb,
                               gb, wl, heads, eps, fast, against_fp32=True)
        bwd_err = {k: max(v, errs[k]) for k, v in bwd_err.items()}
    # other shapes: S < 16, S = 17 and 256, a ragged B at S = 197, D = 256
    # (the widest of the kit's registers route) and 128 with mlp 320 (its
    # 64-column tiles), and the ViT-Small width (the wide route, phase 14 at
    # full size); both gelu forms
    for b_, s_, d_, h_, m_, f_ in ((3, 5, 192, 3, 768, True), (2, 17, 192, 3, 768, False),
                                   (1, 256, 192, 3, 768, True), (7, 197, 192, 3, 768, False),
                                   (2, 40, 256, 4, 1024, True), (3, 9, 128, 2, 320, False),
                                   (5, 50, 384, 6, 1536, True)):
        w_ = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d_, m_, dev))
        x_ = torch.randn(b_, s_, d_, generator=gen).to(torch.bfloat16).to(dev)
        g_ = (0.1 * torch.randn(b_, s_, d_, generator=gen)).to(torch.bfloat16).to(dev)
        check_layer_bwd(f"B={b_} S={s_} D={d_} heads={h_} mlp={m_} fast_gelu={f_}", fb, x_,
                        g_, w_, h_, eps, f_, against_fp32=False)
    # two runs of each half at the training shape: the same weight-gradient bits
    runs = [(fb.mlp_bwd(x2_, gb, wl, eps, True), fb.attn_bwd(xb, gb, wl, heads, eps))
            for x2_ in (xb, xb)]
    torch.cuda.synchronize()
    same = all(torch.equal(runs[0][0][1][n], runs[1][0][1][n]) for n in fb.MLP_NAMES) and all(
        torch.equal(runs[0][1][1][n], runs[1][1][1][n]) for n in fb.ATTN_NAMES)
    same_dx = all(torch.equal(runs[0][i][0], runs[1][i][0]) for i in range(2))
    log(f"[determinism] two runs of mlp_bwd and attn_bwd, B={TRAIN_BATCH}: weight gradients "
        f"bitwise equal {same}, dx2 / dx bitwise equal {same_dx}")
    if not (same and same_dx):
        raise AssertionError("the backward halves are not deterministic")
    del runs
    # the 12-layer backward through the Function, and its determinism
    fast = fast_gelu_default()
    xg = xb.clone().requires_grad_(True)
    wg = tuple(t.clone().requires_grad_(True) for t in wt)
    grads = []
    for _ in range(2):
        out = fused_backbone(xg, wg, heads, eps, fast)
        dx, *dws = torch.autograd.grad(out, (xg, *wg), gb)
        torch.cuda.synchronize()
        grads.append((dx, dws))
    # the forward at the training shape, with the residuals the backward
    # reads, against its plain twin (the forward phase's tolerances)
    got = fused_backbone(xb, wt, heads, eps, fast, emit_res=True)
    torch.cuda.synchronize()
    ref = backbone_forward_plain(xb, wt, heads, eps, fast, emit_res=True)
    for name, a, b in zip(("out", "xs", "x2s"), got, ref):
        diff = (a.float() - b.float()).abs()
        mx, mean = float(diff.max()), float(diff.mean())
        log(f"[kernel-vs-plain] B={TRAIN_BATCH} emit_res=True {name}: max_abs_err "
            f"{mx:.6g} mean_abs_err {mean:.3g} (tol max {KERNEL_MAX_ABS_TOL}, mean "
            f"{KERNEL_MEAN_ABS_TOL})")
        if not (mx <= KERNEL_MAX_ABS_TOL and mean <= KERNEL_MEAN_ABS_TOL):
            raise AssertionError(f"kernel disagrees with its plain twin at the training "
                                 f"shape ({name})")
        max_err = max(max_err, mx)
    ref32 = backbone_forward_plain(xb.float(), wt32, heads, eps, fast)
    err_k = float((got[0].float() - ref32).abs().mean())
    err_p = float((ref[0].float() - ref32).abs().mean())
    log(f"[kernel-vs-fp32] B={TRAIN_BATCH} emit_res=True: mean_abs_err kernel "
        f"{err_k:.6g}, plain twin {err_p:.6g} (tol ratio {KERNEL_VS_FP32_RATIO})")
    if not err_k <= KERNEL_VS_FP32_RATIO * err_p:
        raise AssertionError("kernel is less accurate than its plain twin at the "
                             "training shape")
    _, xs, x2s = got
    del ref, ref32
    ref_dx, ref_dw = fb.backbone_backward_plain(xs, x2s, gb, wt, heads, eps, fast)
    worst = (0.0, 0.0)
    for n, a, b in zip(("dx",) + fb.WEIGHT_NAMES, [grads[0][0], *grads[0][1]],
                       [ref_dx, *[t.to(w.dtype) for t, w in zip(ref_dw, wt)]]):
        mx_rel, mean_rel = rel_err(a, b)
        worst = (max(worst[0], mx_rel), max(worst[1], mean_rel))
        if not (mx_rel <= BWD12_MAX_REL_TOL and mean_rel <= BWD12_MEAN_REL_TOL):
            raise AssertionError(f"12-layer backward disagrees with the plain twin at {n}: "
                                 f"max {mx_rel:.3g}, mean {mean_rel:.3g} relative")
    log(f"[backward-12-layers] Function vs backbone_backward_plain, B={TRAIN_BATCH}: "
        f"largest relative difference {worst[0]:.3g}, mean {worst[1]:.3g} over dx and "
        f"12 weight gradients (tol {BWD12_MAX_REL_TOL}, {BWD12_MEAN_REL_TOL})")
    same = all(torch.equal(a, b) for a, b in zip(grads[0][1], grads[1][1]))
    same_dx = torch.equal(grads[0][0], grads[1][0])
    log(f"[determinism] two backward runs: weight gradients bitwise equal {same}, "
        f"dx bitwise equal {same_dx}")
    if not (same and same_dx):
        raise AssertionError("the backward is not deterministic")
    del xg, wg, grads, got, xs, x2s, ref_dx, ref_dw

    # -- 5. the fp32-inside attention kernels vs their plain twins -------------
    flash_err = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for b_, s_, h_, dt in ((TRAIN_BATCH, s, heads, torch.bfloat16),
                           (BATCH, s, heads, torch.bfloat16),
                           (3, 5, 3, torch.bfloat16), (2, 17, 2, torch.bfloat16),
                           (1, 256, 3, torch.bfloat16), (7, s, heads, torch.bfloat16),
                           (4, s, heads, torch.float32), (2, 50, 1, torch.float32)):
        errs = check_flash(f"B={b_} S={s_} H={h_} {str(dt)[6:]}",
                           *flash_operands(gen, b_, s_, h_, dt, dev))
        flash_err = {k: max(v, errs[k]) for k, v in flash_err.items()}
    runs = [fa.flash_bwd(*flash_operands(torch.Generator().manual_seed(SEED), TRAIN_BATCH, s,
                                         heads, torch.bfloat16, dev)) for _ in range(2)]
    torch.cuda.synchronize()
    same = [torch.equal(a, b) for a, b in zip(*runs)]
    log(f"[determinism] two flash backward runs, B={TRAIN_BATCH} bf16: dq, dk, dv bitwise "
        f"equal {same}")
    if not all(same):
        raise AssertionError("the flash backward is not deterministic")
    del runs

    # -- 6. the one-layer forward kernel vs its plain twin ---------------------
    layer_err = 0.0
    for b_ in (TRAIN_BATCH, BATCH):
        w0 = tuple(t[0] for t in wt)
        x_ = x[:b_].contiguous()
        for fast in (False, True):
            layer_err = max(layer_err, check_layer_fwd(
                f"B={b_} fast_gelu={fast}", fb, x_, w0, heads, eps, fast))
    for fast in (False, True):
        h = xb
        for l in range(layers):
            h = fb.fused_block(h, tuple(t[l] for t in wt), heads, eps, fast)
        hb = fused_backbone(xb, wt, heads, eps, fast)
        torch.cuda.synchronize()
        share = equal_bits(h, hb)
        log(f"[layer_fwd-vs-backbone] B={TRAIN_BATCH} fast_gelu={fast}: {layers} fused_block "
            f"calls vs one fused_backbone: {100.0 * share:.4f}% of the outputs equal bit "
            f"for bit (must be 100%: one layer code)")
        if share != 1.0:
            raise AssertionError("the per-layer forward differs from the backbone forward")

    # -- 7. the merged layer backward vs the split kernels and its twin -------
    x2b = torch.randn(TRAIN_BATCH, s, d, generator=gen).to(torch.bfloat16).to(dev)
    merged_err = 0.0
    for fast in (False, True):
        merged_err = max(merged_err, check_merged_bwd(
            f"B={TRAIN_BATCH} fast_gelu={fast}", fb, xb, x2b, gb, wl, heads, eps, fast, True))
    # a ragged B at S = 197, D = 128 with mlp 320, D = 256 and the ViT-Small
    # width (the kit's routes: equal bits required)
    for b_, s_, d_, h_, m_, f_ in ((7, 197, 192, 3, 768, False), (3, 9, 128, 2, 320, True),
                                   (2, 40, 256, 4, 1024, False), (5, 50, 384, 6, 1536, True)):
        w_ = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, d_, m_, dev))
        x_, x2_, g_ = (torch.randn(b_, s_, d_, generator=gen) for _ in range(3))
        x_, x2_, g_ = (t.to(torch.bfloat16).to(dev) for t in (x_, x2_, 0.1 * g_))
        check_merged_bwd(f"B={b_} S={s_} D={d_} heads={h_} mlp={m_} fast_gelu={f_}", fb, x_,
                         x2_, g_, w_, h_, eps, f_, True)
    # one call's launches: the wrapper's counter, and its CUDA launches
    reset_launches()
    fb.merged_bwd(xb, x2b, gb, wl, heads, eps, True)
    torch.cuda.synchronize()
    counts = read_launches()
    per_call = fb.cuda_launches("merged_bwd", None, d, 0, heads=heads, mlp=mlp)
    split_calls = fb.cuda_launches("mlp_bwd", None, d, 0, heads=heads, mlp=mlp) + fb.cuda_launches("attn_bwd", None, d, 0, heads=heads, mlp=mlp)
    log(f"[merged_bwd] one call at B={TRAIN_BATCH}: merged_bwd counter {counts['merged_bwd']}, "
        f"{per_call} CUDA launches per call (the split pair: {split_calls}; one reduction "
        f"launch for both halves)")
    if counts["merged_bwd"] != 1 or any(n for k, n in counts.items() if k != "merged_bwd"):
        raise AssertionError(f"one merged call launched {counts}")
    if per_call != split_calls - 1:
        raise AssertionError(f"merged_bwd makes {per_call} CUDA launches, not {split_calls - 1}")
    runs = [fb.merged_bwd(xb, x2b, gb, wl, heads, eps, True) for _ in range(2)]
    torch.cuda.synchronize()
    same = all(torch.equal(runs[0][1][n], runs[1][1][n]) for n in fb.WEIGHT_NAMES)
    log(f"[determinism] two merged backward runs: weight gradients bitwise equal {same}, "
        f"dx bitwise equal {torch.equal(runs[0][0], runs[1][0])}")
    if not same:
        raise AssertionError("the merged backward is not deterministic")
    del runs

    # -- 7b. the fp32 routes (compute_dtype=float32) vs their fp32 twins -------
    fp32_err = check_fp32_layer(f"B={TRAIN_BATCH} S={s} D={d}", fb, xb.float(), x2b.float(),
                                gb.float(), wl, heads, eps, True)
    w_ = layer_weights(fb.WEIGHT_NAMES, random_backbone(gen, 1, 384, 1536, dev))
    x_, x2_, g_ = (torch.randn(3, 17, 384, generator=gen).to(dev) for _ in range(3))
    for k, v in check_fp32_layer("B=3 S=17 D=384 heads=6 mlp=1536", fb, x_, x2_, 0.1 * g_,
                                 w_, 6, eps, False).items():
        fp32_err[k] = max(fp32_err[k], v)
    wt64 = tuple(t.double() for t in wt32)
    x32 = x.float()
    for emit in (False, True):
        got = fused_backbone(x32, wt32, heads, eps, fast, emit)
        torch.cuda.synchronize()
        ref = backbone_forward_plain(x32, wt32, heads, eps, fast, emit)
        ref64 = backbone_forward_plain(x32.double(), wt64, heads, eps, fast, emit)
        got, ref, ref64 = ((t,) if not emit else t for t in (got, ref, ref64))
        fp32_err["backbone_fwd"] = check_fp32_outputs(
            "backbone_fwd-fp32", f"B={BATCH} L={layers} emit_res={emit}",
            ("out", "xs", "x2s"), got, ref, ref64, FP32_TOL_12)
    del ref64
    # the 12-layer backward through the Function, fp32, against the twin's
    b12 = 32
    xg = x32[:b12].clone().requires_grad_(True)
    wg = tuple(t.clone().requires_grad_(True) for t in wt32)
    out = fused_backbone(xg, wg, heads, eps, fast)
    g12 = 0.1 * torch.randn(out.shape, generator=gen).to(dev)
    dx12, *dw12 = torch.autograd.grad(out, (xg, *wg), g12)
    torch.cuda.synchronize()
    _, xs12, x2s12 = backbone_forward_plain(x32[:b12], wt32, heads, eps, fast, True)
    rdx, rdw = fb.backbone_backward_plain(xs12, x2s12, g12, wt32, heads, eps, fast)
    _, xs64, x2s64 = backbone_forward_plain(x32[:b12].double(), wt64, heads, eps, fast, True)
    rdx64, rdw64 = fb.backbone_backward_plain(xs64, x2s64, g12.double(), wt64, heads, eps, fast)
    check_fp32_outputs("backward-12-layers-fp32", f"B={b12} L={layers}",
                       ("dx",) + fb.WEIGHT_NAMES, [dx12, *dw12], [rdx, *rdw],
                       [rdx64, *rdw64], FP32_TOL_12)
    del xg, wg, dw12, xs12, x2s12, xs64, x2s64, rdw, rdw64
    # a refused launch raises: the C entry point rejects M = 0 (no twin runs)
    lib = fb._load("mlp_bwd")
    rc = lib.vit2spn_mlp_bwd(*[None] * 19, 0, d, mlp, eps, 1, 1, None)
    try:
        fb._raise_on(lib, rc, "mlp backward")
        raise AssertionError("a refused fp32 launch did not raise")
    except RuntimeError as e:
        log(f"[fp32] a refused launch raises: {e}")

    # -- 8. the serving path end to end, through each backbone path -----------
    ds = synthetic_dataset(split_sizes={"all": N_IMAGES}, image_size=28, seed=SEED)
    quiet = MetricLogger(echo=False)
    trainer = SSPTrainer(cfg, logger=quiet, device="cuda")
    trainer.extract_features(ds, batch_size=BATCH)  # warm-up (allocator, build)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    feats, labels = trainer.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    extract_launches = read_launches()
    log(f"[extract] {feats.shape} features, {extract_launches[KERNEL_NAME]} backbone kernel "
        f"launches ({extract_launches[KERNEL_NAME] * layers * kernel_launches_per_layer(d, False, heads, mlp)} "
        f"CUDA kernel launches), {extract_s:.3f} s, {N_IMAGES / extract_s:.1f} img/s")
    if extract_launches[KERNEL_NAME] <= 0:
        raise AssertionError("the serving path never launched the backbone kernel")
    if any(n for k, n in extract_launches.items() if k != KERNEL_NAME):
        raise AssertionError(f"the serving path launched another kernel: {extract_launches}")
    if feats.shape != (N_IMAGES, cfg.proj_dim) or not np.isfinite(feats).all():
        raise AssertionError(f"bad features: shape {feats.shape}, "
                             f"finite {np.isfinite(feats).all()}")
    if labels.shape != (N_IMAGES,):
        raise AssertionError(f"bad labels shape {labels.shape}")
    trainer.attn_impl = "plain"
    feats_plain, _ = trainer.extract_features(ds, batch_size=BATCH)
    scale = float(np.abs(feats_plain).max())
    feat_err = float(np.abs(feats - feats_plain).max())
    log(f"[extract-vs-plain] max_abs_err {feat_err:.6g} (max |plain| {scale:.4g}, "
        f"tol {FEATURE_REL_TOL} relative)")
    if not feat_err <= FEATURE_REL_TOL * scale:
        raise AssertionError("served features disagree with the plain path")
    extract_path(trainer, ds, "pallas", feats_plain, ("flash_fwd",))
    extract_path(trainer, ds, "fused_layer", feats_plain, ("layer_fwd",))
    del trainer

    # -- 8b. serving under compute_dtype=float32, through the fp32 kernels -----
    cfg32 = replace(cfg, compute_dtype="float32")
    trainer32 = SSPTrainer(cfg32, logger=quiet, device="cuda")
    trainer32.attn_impl = "plain"
    feats32_plain, _ = trainer32.extract_features(ds, batch_size=BATCH)
    extract_path(trainer32, ds, "fused", feats32_plain, (KERNEL_NAME,),
                 tol=FP32_FEATURE_REL_TOL, what="fused fp32")
    del trainer32

    # -- 9. the training path end to end ---------------------------------------
    tcfg = replace(cfg, batch_size=TRAIN_BATCH)
    eff = tcfg.effective_batch
    a = tcfg.accumulation_steps
    tds = synthetic_dataset(split_sizes={"train": TRAIN_IMAGES}, image_size=28,
                            seed=SEED).split("train")
    step_check(tcfg, tds.images[:eff], tcfg.learning_rate)
    torch.cuda.empty_cache()
    # per optimizer step: 2 streams x (online under grad + target) backbone
    # forwards per microbatch, 2 online backwards of every layer
    split = {"mlp_bwd": 2 * a * layers, "attn_bwd": 2 * a * layers}
    trainer, train_launches, _ = fit_path(tcfg, tds, "fused", False,
                                          {KERNEL_NAME: 2 * 2 * a, **split})

    # -- 9b. training under compute_dtype=float32 through the fp32 kernels -----
    # step 1 of "fused" against "plain" from the same state, then one step of
    # each fused path with the counters read around it
    tcfg32 = replace(tcfg, compute_dtype="float32")
    fds = synthetic_dataset(split_sizes={"train": FP32_IMAGES}, image_size=28,
                            seed=SEED + 2).split("train")
    step_check(tcfg32, fds.images[:eff], tcfg32.learning_rate)
    torch.cuda.empty_cache()
    fp32_launches = {}
    for impl, merged, per_step in (
            ("fused", False, {KERNEL_NAME: 2 * 2 * a, **split}),
            ("fused_layer", False, {"layer_fwd": 2 * 2 * a * layers, **split}),
            ("fused", True, {KERNEL_NAME: 2 * 2 * a, "merged_bwd": 2 * a * layers})):
        t32, launches32, _ = fit_path(tcfg32, fds, impl, merged, per_step)
        fp32_launches.update({k: n for k, n in launches32.items() if n})
        del t32
        torch.cuda.empty_cache()
    os.environ["VIT2SPN_MERGED_BWD"] = "0"

    # -- 9c. the pretrained init from a local weight file -----------------------
    check_pretrained_init(cfg, dev)

    # -- 10. the other backbone paths end to end -------------------------------
    pds = synthetic_dataset(split_sizes={"train": PATH_IMAGES}, image_size=28,
                            seed=SEED + 1).split("train")
    per_layer_fwd = 2 * 2 * a * layers
    paths = (
        # (attn_impl, merged backward, its reference path, launches per step)
        ("pallas", False, ("xla", False),
         {"flash_fwd": per_layer_fwd, "flash_bwd": 2 * a * layers}),
        ("fused_layer", False, ("fused", False), {"layer_fwd": per_layer_fwd, **split}),
        ("fused", True, ("fused", False),
         {KERNEL_NAME: 2 * 2 * a, "merged_bwd": 2 * a * layers}),
    )
    path_launches, step_ms = {}, {}
    rest = "views, embed, heads, loss, Adam, EMA"
    for impl, merged, ref_path, per_step in paths:
        step_check(tcfg, pds.images[:eff], tcfg.learning_rate, (impl, merged), ref_path)
        torch.cuda.empty_cache()
        ptrainer, launches, _ = fit_path(tcfg, pds, impl, merged, per_step)
        path_launches.update({k: n for k, n in launches.items() if n})
        name = f"{impl}{' merged' if merged else ''}"
        if merged:  # the merged step's backward launches against the split step's
            calls = per_step["merged_bwd"]
            log(f"[train] {name}: {calls} merged_bwd calls per step x "
                f"{fb.cuda_launches('merged_bwd', None, d, 0, heads=heads, mlp=mlp)} CUDA launches; the split step's "
                f"{calls} x ({fb.cuda_launches('mlp_bwd', None, d, 0, heads=heads, mlp=mlp)} + "
                f"{fb.cuda_launches('attn_bwd', None, d, 0, heads=heads, mlp=mlp)})")
        step_ms[name] = 1e3 * time_steps(
            ptrainer, eff, name, card, tuple(per_step),
            ("the per-op blocks' LayerNorms, GEMMs and gelu, " + rest) if impl == "pallas"
            else rest)
        os.environ["VIT2SPN_MERGED_BWD"] = "0"
        del ptrainer
        torch.cuda.empty_cache()

    # -- 10b. the fine-tune path end to end ----------------------------------------
    ft_launches = finetune_path(trainer, card, ft_fresh_s)

    # -- 12. the folder datasets and the parity runbook end to end ------------------
    folder_launches = folder_path(trainer, card)

    # -- 11. times ---------------------------------------------------------------
    fast = fast_gelu_default()
    kernel_ms = time_ms(lambda: fused_backbone(x, wt, heads, eps, fast))
    plain_ms = time_ms(lambda: backbone_forward_plain(x, wt, heads, eps, fast),
                       iters=5, warmup=1)
    with torch.no_grad():
        library_ms = time_ms(lambda: library_backbone(x, wt, heads, eps))
    bound_ms, bound_by, flops = backbone_bound_ms(BATCH, s, d, heads, mlp,
                                                  layers, wt)
    log(f"[time] backbone forward B={BATCH}: kernel {kernel_ms:.3f} ms "
        f"({kernel_ms / (layers * kernel_launches_per_layer(d, False, heads, mlp)):.4f} ms per CUDA "
        f"launch, {layers * kernel_launches_per_layer(d, False, heads, mlp)} launches), plain twin "
        f"{plain_ms:.3f} ms, library {library_ms:.3f} ms, bound {bound_ms:.4f} ms "
        f"({bound_by}; {flops / 1e9:.1f} GFLOP), kernel at "
        f"{flops / (kernel_ms * 1e-3) / 1e12:.1f} TFLOP/s")
    # by stage, the kernel's and the library yardstick's, one after the other
    for line in stage_breakdown(lambda: fused_backbone(x, wt, heads, eps, fast),
                                "kernel: one backbone forward"):
        log(line)
    with torch.no_grad():
        for line in stage_breakdown(lambda: library_backbone(x, wt, heads, eps),
                                    "library yardstick: one backbone forward"):
            log(line)
    # the attention stage: its device time per launch (STAGE_CALLS calls
    # traced: the trace may drop a run's first launches) times the launches
    # of one call (the forward's layers, or one layer), beside SDPA's on the
    # same B x heads attentions and the stage's bound
    att = {}
    for tag, b_, calls, fn in (
            ("backbone_fwd", BATCH, layers, lambda: fused_backbone(x, wt, heads, eps, fast)),
            ("layer_fwd", TRAIN_BATCH, 1,
             lambda: fb.layer_fwd(xb, tuple(t[0] for t in wt), heads, eps, fast))):
        totals = {}
        stage_breakdown(lambda: [fn() for _ in range(STAGE_CALLS)], totals=totals)
        a_ms, a_n = attention_stage_ms(totals)
        if not a_n:
            raise AssertionError(f"no attention_kernel launch in the {tag} trace")
        a_ms = calls * a_ms / a_n
        sd_ms, sd_n = sdpa_call_ms(b_, s, d, heads, dev)
        sd_ms *= calls
        bnd_ms, bnd_by = attention_stage_bound_ms(b_, s, d, calls)
        att[tag] = {"attention_stage_ms": a_ms, "attention_stage_bound_ms": bnd_ms,
                    "attention_library_ms": sd_ms}
        log(f"[time] attention stage of {tag} B={b_} ({calls} launch{'es' * (calls > 1)}): "
            f"kernel {a_ms:.4f} ms device (mean of {a_n} launches traced), SDPA {sd_ms:.4f} "
            f"ms device ({calls} call{'s' * (calls > 1)}; mean of {sd_n} traced), bound "
            f"{bnd_ms:.4f} ms ({bnd_by}); kernel at {100 * bnd_ms / a_ms:.1f}% of the bound, "
            f"SDPA at {100 * bnd_ms / sd_ms:.1f}%; {card}")
    entries = [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "vit2spn_tpu_torch/csrc/backbone_fwd.cu",
        "replaces": "vit2spn_tpu/ops/fused_block.py:694",
        "launches": train_launches[KERNEL_NAME],
        "finetune_launches": ft_launches.get(KERNEL_NAME, 0),
        "folder_launches": folder_launches.get(KERNEL_NAME, 0), "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms, "library_same_fn_ms": None,
        "dtype": "bfloat16", **att["backbone_fwd"],
    }]
    # the new kernels at their paths' shapes: B=128, bf16
    q, k, v, do = flash_operands(gen, TRAIN_BATCH, s, heads, torch.bfloat16, dev)
    w0 = tuple(t[0] for t in wt)
    same_fn = check_same_fn_yardstick(q, k, v, do)
    merged_lib = (lambda: library_attn_half(
        xb, library_mlp_half(x2b, gb, wl, eps)[0].to(xb.dtype), wl, heads, eps))
    timed = (
        # name, source, replaces, (ms, "operations" | "bytes", flops), CUDA launches,
        # max_abs_err, kernel, plain twin, library yardstick (never called by the port)
        # and, where the library call keeps P and dS in fp32, that one
        ("mlp_bwd", "mlp_bwd.cu", "vit2spn_tpu/ops/fused_block.py:342",
         bwd_bound_ms("mlp", TRAIN_BATCH, s, d, heads, mlp, wl),
         fb.cuda_launches("mlp_bwd", None, d, 0, heads=heads, mlp=mlp), bwd_err["mlp_bwd"],
         lambda: fb.mlp_bwd(xb, gb, wl, eps, fast),
         lambda: fb.mlp_bwd_plain(xb, gb, wl, eps, fast),
         lambda: library_mlp_half(xb, gb, wl, eps), None),
        ("attn_bwd", "attn_bwd.cu", "vit2spn_tpu/ops/fused_block.py:357",
         bwd_bound_ms("attn", TRAIN_BATCH, s, d, heads, mlp, wl),
         fb.cuda_launches("attn_bwd", None, d, 0, heads=heads, mlp=mlp), bwd_err["attn_bwd"],
         lambda: fb.attn_bwd(xb, gb, wl, heads, eps),
         lambda: fb.attn_bwd_plain(xb, gb, wl, heads, eps),
         lambda: library_attn_half(xb, gb, wl, heads, eps), None),
        ("merged_bwd", "merged_bwd.cu", "vit2spn_tpu/ops/fused_block.py:375",
         bwd_bound_ms("merged", TRAIN_BATCH, s, d, heads, mlp, wl),
         fb.cuda_launches("merged_bwd", None, d, 0, heads=heads, mlp=mlp), merged_err,
         lambda: fb.merged_bwd(xb, x2b, gb, wl, heads, eps, fast),
         lambda: fb.merged_bwd_plain(xb, x2b, gb, wl, heads, eps, fast), merged_lib, None),
        ("layer_fwd", "layer_fwd.cu", "vit2spn_tpu/ops/fused_block.py:170",
         backbone_bound_ms(TRAIN_BATCH, s, d, heads, mlp, 1, w0, acts=3),
         fb.cuda_launches("layer_fwd", None, d, 0, heads=heads, mlp=mlp), layer_err,
         lambda: fb.layer_fwd(xb, w0, heads, eps, fast),
         lambda: fb.layer_forward_plain(xb, w0, heads, eps, fast),
         lambda: library_backbone(xb, tuple(t[:1] for t in wt), heads, eps), None),
        ("flash_fwd", "flash_attention.cu", "vit2spn_tpu/ops/flash_attention.py:36",
         flash_bound_ms("fwd", TRAIN_BATCH, s, heads), fb.cuda_launches("flash_fwd", fa.KERNEL_NAME),
         flash_err["flash_fwd"], lambda: fa.flash_fwd(q, k, v),
         lambda: fa.flash_attention_plain(q, k, v),
         lambda: F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in (q, k, v))),
         same_fn[0]),
        ("flash_bwd", "flash_attention.cu", "vit2spn_tpu/ops/flash_attention.py:53",
         flash_bound_ms("bwd", TRAIN_BATCH, s, heads), fb.cuda_launches("flash_bwd", fa.KERNEL_NAME),
         flash_err["flash_bwd"], lambda: fa.flash_bwd(q, k, v, do),
         lambda: fa.flash_attention_bwd_plain(q, k, v, do),
         library_flash_bwd(q, k, v, do)[0], same_fn[1]),
    )
    # the fp32 routes (compute_dtype=float32) at the same shapes, the backbone
    # at B=256; their launches are the fp32 training steps' (phase 9b)
    x32, xb32, x2b32, gb32 = x.float(), xb.float(), x2b.float(), gb.float()
    wl32 = {n: t.float() for n, t in wl.items()}
    w032 = tuple(t.float() for t in w0)
    timed += (
        ("backbone_fwd (fp32)", "backbone_fwd.cu", "vit2spn_tpu/ops/fused_block.py:694",
         backbone_bound_ms(BATCH, s, d, heads, mlp, layers, wt32),
         layers * kernel_launches_per_layer(d, True, heads, mlp), fp32_err["backbone_fwd"],
         lambda: fused_backbone(x32, wt32, heads, eps, fast),
         lambda: backbone_forward_plain(x32, wt32, heads, eps, fast),
         lambda: library_backbone(x32, wt32, heads, eps), None),
        ("mlp_bwd (fp32)", "mlp_bwd.cu", "vit2spn_tpu/ops/fused_block.py:342",
         bwd_bound_ms("mlp", TRAIN_BATCH, s, d, heads, mlp, wl32),
         fb.cuda_launches("mlp_bwd", None, d, 1, heads=heads, mlp=mlp), fp32_err["mlp_bwd"],
         lambda: fb.mlp_bwd(xb32, gb32, wl32, eps, fast),
         lambda: fb.mlp_bwd_plain(xb32, gb32, wl32, eps, fast),
         lambda: library_mlp_half(xb32, gb32, wl32, eps), None),
        ("attn_bwd (fp32)", "attn_bwd.cu", "vit2spn_tpu/ops/fused_block.py:357",
         bwd_bound_ms("attn", TRAIN_BATCH, s, d, heads, mlp, wl32),
         fb.cuda_launches("attn_bwd", None, d, 1, heads=heads, mlp=mlp), fp32_err["attn_bwd"],
         lambda: fb.attn_bwd(xb32, gb32, wl32, heads, eps),
         lambda: fb.attn_bwd_plain(xb32, gb32, wl32, heads, eps),
         lambda: library_attn_half(xb32, gb32, wl32, heads, eps), None),
        ("merged_bwd (fp32)", "merged_bwd.cu", "vit2spn_tpu/ops/fused_block.py:375",
         bwd_bound_ms("merged", TRAIN_BATCH, s, d, heads, mlp, wl32),
         fb.cuda_launches("merged_bwd", None, d, 1, heads=heads, mlp=mlp), fp32_err["merged_bwd"],
         lambda: fb.merged_bwd(xb32, x2b32, gb32, wl32, heads, eps, fast),
         lambda: fb.merged_bwd_plain(xb32, x2b32, gb32, wl32, heads, eps, fast),
         lambda: library_attn_half(xb32, library_mlp_half(x2b32, gb32, wl32, eps)[0], wl32,
                                   heads, eps), None),
        ("layer_fwd (fp32)", "layer_fwd.cu", "vit2spn_tpu/ops/fused_block.py:170",
         backbone_bound_ms(TRAIN_BATCH, s, d, heads, mlp, 1, w032, acts=3),
         fb.cuda_launches("layer_fwd", None, d, 1, heads=heads, mlp=mlp), fp32_err["layer_fwd"],
         lambda: fb.layer_fwd(xb32, w032, heads, eps, fast),
         lambda: fb.layer_forward_plain(xb32, w032, heads, eps, fast),
         lambda: library_backbone(xb32, tuple(t[:1] for t in wt32), heads, eps), None),
    )
    # mlp_bwd / attn_bwd: their counts on the "fused" path, as before; the
    # fp32 routes' on the fp32 paths
    launches = {**path_launches, **{k: n for k, n in train_launches.items() if n},
                **{f"{k} (fp32)": n for k, n in fp32_launches.items()}}
    for name, src, replaces, bound, n_cuda, err, kernel, twin, library, same in timed:
        b_ms, b_by, b_flops = bound
        k_ms = time_ms(kernel)
        p_ms = time_ms(twin, iters=5, warmup=1)
        forward = name.split()[0] in ("layer_fwd", "flash_fwd", KERNEL_NAME)
        with torch.no_grad() if forward else torch.enable_grad():
            l_ms = time_ms(library)
            s_ms = time_ms(same) if same else None
        batch = BATCH if name.startswith(KERNEL_NAME) else TRAIN_BATCH
        log(f"[time] {name} B={batch}: kernel {k_ms:.4f} ms ({n_cuda} CUDA launches), "
            f"plain twin {p_ms:.3f} ms, library {l_ms:.4f} ms"
            + (f" (fp32, the same function: {s_ms:.4f} ms)" if same else "")
            + f", bound {b_ms:.4f} ms ({b_by}; {b_flops / 1e9:.2f} GFLOP), kernel at "
            f"{b_flops / (k_ms * 1e-3) / 1e12:.1f} TFLOP/s, {100 * b_ms / k_ms:.1f}% of the bound")
        entries.append({
            "name": name, "route": "cuda", "source": f"vit2spn_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "finetune_launches": ft_launches.get(name, 0),
            "folder_launches": folder_launches.get(name, 0), "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": l_ms, "library_same_fn_ms": s_ms,
            "dtype": "float32" if name.endswith("(fp32)") else "bfloat16",
            **att.get(name, {}),
        })
    # the backward kernels by stage (CUDA kernel), B=128, bf16 and fp32,
    # over STAGE_CALLS calls (the trace drops a call's first few launches)
    for name, fn in (("mlp_bwd", lambda: fb.mlp_bwd(xb, gb, wl, eps, fast)),
                     ("attn_bwd", lambda: fb.attn_bwd(xb, gb, wl, heads, eps)),
                     ("merged_bwd", lambda: fb.merged_bwd(xb, x2b, gb, wl, heads, eps, fast)),
                     ("mlp_bwd (fp32)", lambda: fb.mlp_bwd(xb32, gb32, wl32, eps, fast)),
                     ("attn_bwd (fp32)", lambda: fb.attn_bwd(xb32, gb32, wl32, heads, eps))):
        for line in stage_breakdown(lambda: [fn() for _ in range(STAGE_CALLS)],
                                    f"{name} B={TRAIN_BATCH} by stage, {STAGE_CALLS} calls",
                                    top=10):
            log(line)
    time_gemm_f32(fb, TRAIN_BATCH * s, d, mlp, gen, dev)

    trainer_s = SSPTrainer(cfg, logger=quiet, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reps = 3
    for _ in range(reps):
        trainer_s.extract_features(ds, batch_size=BATCH)
    torch.cuda.synchronize()
    e2e = reps * N_IMAGES / (time.perf_counter() - t0)
    log(f"[time] extract end to end (dual stream, pred): {e2e:.1f} img/s "
        f"over {reps} x {N_IMAGES} images on {card}")
    del trainer_s

    step_ms["fused"] = 1e3 * time_steps(trainer, eff, "fused", card,
                                        (KERNEL_NAME, "mlp_bwd", "attn_bwd"), rest)
    log(f"[time] optimizer step by backbone path, ms: {json.dumps(step_ms)}")
    del trainer
    gc.collect()
    torch.cuda.empty_cache()

    # -- 14. the model zoo: ViT-Small and ViT-Base at full width ---------------
    # (before phase 13: after it, a trace in this process held no device time
    # on the H100)
    entries += zoo_path(fb, card, dev)

    # -- 15. inputs above 256 tokens (before phase 13, as phase 14) -------------
    entries += long_seq_path(fb, fa, card, dev)

    # -- 16. fp32 above 256 tokens (before phase 13, as phase 14) --------------
    entries += fp32_long_path(fb, fa, card, dev)

    # -- 17. head_dim 16, 32, 48 and D below 64 (before phase 13, as phase 14) --
    entries += head_dim_path(fb, fa, card, dev)

    # -- 18. ViT-Large/16 at full width and depth (before phase 13, as phase 14;
    # in a process of its own, as phase 17 (b)'s trace)
    entries += vit_large_in_child()

    # -- 19. the general route above 256 tokens (before phase 13, as phase 14;
    # in a process of its own, as phase 18)
    entries += general_long_in_child()

    # -- 20. ViT-Huge/14: head_dim 80 and D 1280 (before phase 13, as phase 14;
    # in a process of its own, as phase 18)
    entries += vit_huge_in_child()

    # -- 13. several ranks on the one card -------------------------------------
    parallel_launches = parallel_path(card)
    for e in entries:
        e["parallel_launches"] = parallel_launches.get(e["name"], 0)

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
