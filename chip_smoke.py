#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:
  1. the card's name and power limit (nvidia-smi);
  2. build the three CUDA kernels from ``neural_ode_metasolver_tpu_torch/
     csrc`` with nvcc for sm_90a, one process per source, all at once;
     print ptxas's registers, spills and warnings, and the tensor-core
     instructions (HMMA, HGMMA) in each library's SASS; fail if B1's or
     B2's has none, the wgrad's has no HGMMA, or any instance of B3's
     backward spills, or if B1's and B2's libraries lack the f32 core
     (``conv3x3_f32_kernel``) or still hold a float instance of the bf16
     gather kernel, or the wgrad's lacks its f32 path;
  3. kernel B1 (``conv3x3_same``) against its plain version at both served
     paths' shapes, batch 256, in f32 and bf16, and at the digits train
     step's ConcatConv2d (128, 6, 6, 65 -> 64) in f32 (TF32 off in phases
     3-6, the process defaults in 7-8; the train step pins full f32
     itself), with timings of the kernel, the plain version and cuDNN's
     ``F.conv2d`` in full f32 for f32 (yardstick), the kernel's TFLOP/s and
     share of its bound, and each f32 row's plan (``conv3x3_f32_plan``),
     which must be the path the launcher takes;
  4. B1's backward against its plain versions at the flagship train step's
     shapes, batch 256, f32 and bf16, and at the MNIST train step's
     ConcatConv2d (128, 6, 6, 65 -> 64) in f32: the dgrad (``conv3x3_dgrad``, B1 on
     flipped weights, the stem's with Cout 3) with the kernel path it took
     (f32: its plan, which must be that path),
     and the wgrad kernel (``conv3x3_wgrad``) with its launch plan, with
     cuDNN's ``conv2d_input`` / ``conv2d_weight`` as yardsticks, and two
     wgrad launches compared bit for bit;
  5. kernel B2 (``ode_block_rk2_forward``) against its plain version at the
     two ODE-block shapes, u = 0.5, 8 steps, f32 and bf16 (33 launches a
     solve: one GELU of y0, four convs a step), with TFLOP/s and share;
  6. kernel B3 (``fused_group_norm_act``) against its plain version at the
     MNIST path's shapes and off the path at (256, 32, 32, 64), batch 256,
     f32 and bf16, and at phase 18's and 20's CIFAR shapes ((256, 32, 32,
     64), (256, 16, 16, 128), (256, 8, 8, 256), (256, 4, 4, 512), 32
     groups, GELU and none) in bf16, with each
     shape's launch plan and timings of the kernel, the plain version and
     ``F.group_norm`` (+ ``F.gelu``; yardstick), beside the launch floor: a
     one-element ``add_`` timed the same way;
 6b. B3's backward (``group_norm_backward``) against its plain version at
     the MNIST train step's shapes, batch 128, relu and none, and off the
     path at (256, 32, 32, 64), f32 and bf16, and at phase 18's and 20's
     shapes in bf16: dx, dscale and dbias of the
     full launch, the dx-only launch's dx and a second full launch bit for
     bit, each shape's launch plan, and timings of both launches, the plain
     version and aten's GroupNorm backward (yardstick);
 6c. the GeLUpoly kernels (``fused_gelu_poly``, ``gelu_poly_backward``)
     against their plain versions computed in f32 at the flagship's two
     activation shapes, bf16 (within one bf16 ulp) and f32 (four ulps):
     launches, bits repeated, device ms of each kernel, of the composition
     and of autograd's backward of it, the bytes bound and the share of
     it, and the host microseconds a call of both;
  7. serve premetanode10 (in_planes 64, seeded random weights) in bf16:
     one warm-up request at each of batch 1, 64 and 256, then five counted
     and timed requests at each size; check the logits and the kernels'
     launch counts, and compare bf16 and f32 serving with the model's plain
     path on the card;
  8. serve the MNIST MetaNODE (dim 64, seeded random weights) in f32, the
     shipped artifact's dtype: one warm-up request at each of batch 1, 128
     and 256, then five counted and timed requests at each size; check the
     launch counts (B3 51, B1 32, B2 0 per request) and the logits against
     the model's plain path on the card;
  9. train: the flagship adversarial step of ``bench.py:94-113``
     (premetanode10, in_planes 64, GeLUpoly, RK2 u=0.5 8 steps with
     Normal(0.0125) smoothing, FGSM-random 8/255 and 10/255, SGD momentum
     0.9, weight decay 5e-4, cyclic lr) at batch 256 in bf16, seeded images
     and labels: one warm-up step, then five counted and timed steps; check
     every loss is finite and the launches per step (B1 136, dgrad 135,
     wgrad 68, GeLUpoly 138 each way, B2 0, B3 0);
 10. the train step's kernel path against its plain path (``F.conv2d``
     with autograd) from one state with the draws pinned: in f32 at batch
     32 the adversarial images (equal but where the input gradient is
     tiny) and the parameter gradients at the same images; in bf16 at batch
     256 one step's loss and gradient norm;
 11. train: the digits recipe of ``scripts/digits_smoothing_experiment.py``
     (MNIST MetaNODE, dim 64, RK2 u=0.5 8 steps with Normal(0.0125)
     smoothing, PGD eps 0.3, lr 2/255, 7 iterations, RMSprop lr 1e-3,
     weight decay 5e-4) at batch 128 in f32, seeded uniform images and
     labels: one warm-up step, five counted and timed steps (median, img/s),
     the launches per step (B3 408 forward and 408 backward, 51 of them
     with dscale and dbias; B1 256, dgrad 256, wgrad 32; B2 0); then its
     kernel path against its plain path from one state: one step's loss
     and gradient norm, and through ``Model.forward`` one PGD step's
     adversarial images and the parameter gradients at the same images;
 12. evaluate: clean ``accuracy`` and PGD-7 ``adversarial_accuracy`` over
     four batches of 256 seeded images, kernel path and plain path, with
     the time of each batch and the launches; the correct counts agree
     (uniform images carry no accuracy, so none is asserted);
 13. the Evaluate-notebook regime table (``notebook_regime_grid``:
     standalone, switch[0.6,0.4], solver_ens[0.6,0.4], model ensembling)
     on the MNIST MetaNODE (dim 64, f32, RK2 u=0.5 8 steps) over four
     seeded batches of 256: clean and FGSM (eps 0.3) accuracy through
     ``accuracy``, ``adversarial_accuracy`` and the ensemble entry points,
     and the clean step-count sweep over 1, 2, 4, 8 (``sn_test`` for
     standalone), kernel path and plain path from the same seeds: exact
     launches per batch, logits within 1e-4 of max(1, max|logit|), clean
     predictions equal but at near-ties (top two scores within twice the
     paths' difference), FGSM counts within 2 a batch, one batch's FGSM in
     f32 with x_adv equal at all but 0.1% of the pixels and at most 1% of
     the input gradients more than 1e-3 of their max apart (ReLU masks
     flip on rounding, as in phase 11; the plain path in f64 against f32
     is printed beside, as what rounding alone moves), sweep counts equal,
     and the median ms per batch after a warm-up batch;
 14. the same table on premetanode10 (in_planes 64, bf16, batch 256, two
     batches), FGSM at eps 8/255 with the CIFAR mean and std: logits within
     2^-5 of max|logit|, the predictions as in 13 (bf16 near-ties flip),
     and the f32 FGSM held to phase 10's bars (x_adv equal wherever the
     input gradient is above 1e-6 of its max, input gradients within 1e-4
     of it); no sweep.
 15. ``mnist_runner.main`` at full width in f32: the digits recipe (as in
     11, PGD-7 training, smoothing, RMSprop lr 1e-3 wd 5e-4, batch 128) on
     1280 synthetic training and 512 test images, 2 epochs with validation
     and a PGD-7 test each: finite losses, the ``native`` data backend,
     exact launches (10 x phase 11's step an epoch, plus one validation
     and one PGD batch), ``last/`` and ``best_solver_0/`` committed with
     their sidecars, the metrics log's config and epoch lines; the seconds
     an epoch, the runner's ``batch_time`` and img/s; then ``--resume
     --nepochs 3 --prefetch 0``, whose restored params and optimizer state
     equal the saved ones bit for bit and whose steps continue from 20 (its
     ``batch_time`` without the prefetch beside the first run's);
 16. ``cifar_runner.main`` at full width in bf16: the flagship recipe (as
     in 9) on 2816 synthetic images (2535 train in 9 steps of 256, 281
     validate), two epochs, each with the PGD-7 test over 512 images at
     batch 256 (in f32, as the JAX runner evaluates, timed through the
     runner): finite losses, exact launches (9 x phase 9's step, plus
     validation and PGD, an epoch), the runner's step time beside phase
     9's bare one (the first epoch's carries the run's first step); then
     the PGD-7 test batches again from the ``last`` checkpoint in bf16
     through ``make_adversarial_predict``, kernel path and plain path from
     the same seeds, ms per batch, correct counts within 2 a batch, and
     the attacked predictions that differ;
 17. ``attacks_runner.main`` over the ``last`` checkpoints of 15 and 16
     (clean, FGSM and PGD-7 at one epsilon each): the CSV's columns and
     rows, and its seconds;
 18. train metanode10 (the basic-block family) with GroupNorm of 32 groups
     in every slot and the exact GELU, which B3 fuses, under phase 9's
     recipe at batch 256 in bf16: one warm-up step, five counted and timed
     steps, finite losses and the launches a step (B1 136, dgrad 135,
     wgrad 68, B3 140 forward and 140 backward, 70 of them with dscale and
     dbias, B2 0); then, with phase 10's checks but for the comparison of
     the adversarial images, kernel path against plain path from one
     state: in f32 at batch 32 the parameter gradients at the same images
     (1e-4 of max|g|), in bf16 at batch 256 one step's loss (2e-2) and
     gradient norm (5e-2), and the clean eval logits of two batches of 256 in bf16
     (2^-5 of max|logit|);
 19. ``cifar_runner.main`` with a model state: premetanode10 with BN in the
     res blocks and bn1, SN in the res and ODE blocks and the orthogonal
     init, in bf16 at batch 256 on synthetic data, two epochs of two steps
     with validation: finite losses, exact launches, every BN statistic and
     SN vector moved off the init; ``--resume --nepochs 0`` hands back the
     model state bit for bit, ``--resume --nepochs 1`` trains on; the eval
     logits of the restored model, kernel path against plain path; then
     one clean batch of ResNet-10 (``metanode10 --is_odenet False``) with
     GN: its launches (B1 8, B3 10) and its logits against the plain
     path;
 20. train metanode18 at full width with phase 18's GroupNorms (256
     channels at 8x8, 512 at 4x4) under phase 9's recipe at batch 256 in
     bf16: one warm-up and one counted step (its ms and peak memory),
     finite losses and the launches a step (B1 268, dgrad 267, wgrad 134,
     B3 280 forward and 280 backward, 140 of them with dscale and dbias);
     then kernel path against plain path with phase 18's bars;
 21. phase 9's flagship step under the continuous adjoint
     (``integration_method="adjoint"``) on phase 9's images: one warm-up
     and five counted and timed steps, finite losses, the launches a step
     (B1 264: each pass's 68 and the backward's 64 recomputed RHS convs;
     dgrad 135, wgrad 68, GeLUpoly 266 forward and 138 backward, B2 0,
     B3 0), its ms and peak memory beside phase
     9's, the peak below phase 9's; then phase 10's kernel-against-plain
     bars but for the comparison of the adversarial images;
 22. ``mnist_runner.main --train_solver_params --lr_uv 0.01`` with phase
     15's digits flags, 2 epochs: finite losses, the logged u moved off
     0.5 and inside [1e-3, 1], exact launches (per epoch 10 x phase 11's
     step and one clean validation batch), ``solver_trained`` restoring
     params, u and both optimizer states bit for bit, the ms a step beside
     phase 11's; then from one state one ``make_solver_train_step`` step,
     kernel path against plain path (loss within 2e-2), and at phase 11's
     images u's gradient within 1e-3 relative and the param grads within
     1e-3 of max|g|;
 23. the member-batched launches of a fleet (``training/fleet.py``) at 16
     members of 128 images, at the MNIST u-sweep step's shapes in f32: B1
     at (6, 6, 65 -> 64), its dgrad and the f32 wgrad, B3 forward and
     backward (dx only and full) at 26x26, 13x13 and 6x6 with 64 channels,
     relu and none; each bit-equal to 16 single launches and within
     phases 4 and 6b's bars of its plain version, its path or plan the
     single run's, with device ms of the launch, of 16 single launches,
     of the plain version, of the library call (cuDNN's grouped conv in
     full f32 for B1) and the bound, and the share of it;
 24. the u-sweep step (MNIST dim 64, batch 128 a member, f32, RK2 8 steps,
     RMSprop 1e-3, clean) as one fleet of 16 members (4 u x 4 seeds): one
     warm-up and five timed steps beside a single run's, finite losses,
     the launches of a fleet step equal to a single step's, img/s, peak
     memory; step ms and peak memory at 1, 4, 8, 16 and 32 members; each
     member against its single run over two steps from one state, cuDNN
     on its deterministic algorithms on both sides (with an f32 against
     f64 witness of what rounding alone moves); the fleet's
     kernel path against its plain path (phase 11's bars); one step under
     PGD-7, launching what a single PGD-7 step launches;
 25. ``u_sweep.main`` (4 u x 2 seeds, 1280 train and 512 test synthetic
     images, 1 epoch) sequentially and with ``--fleet``: 8 rows each, clean
     accuracies within 0.2 of each other, robust ones in [0, 1], the wall
     seconds of both; ``sweep.main`` over two grid points of phase 15's
     ``mnist_runner``, 1 epoch: two committed run directories and two
     summary rows;
 26. export the served models with ``serving.export_model``
     (``torch.export``, B1, B2 and B3 as the ``nodems::`` custom ops of
     ``ops/library.py``): the MNIST MetaNODE (dim 64, f32) and premetanode10
     (in_planes 64, bf16), seeded random weights, a dynamic batch, on the
     card, and the MNIST one on the CPU too; each graph's ops launch what
     the live path launches a request; a fresh ``python3`` process that
     imports only the port's ``serving`` loads each artifact onto the card
     (the CPU's moved there) and the card's MNIST one onto the CPU, and
     serves batch 1, 64 and 256 (a warm-up and five counted and timed
     requests each; on the CPU batch 1): logits within the serving bars of
     the live ``ServedModel`` on the same inputs (f32 1e-4 max(1,
     max|logit|), bf16 2^-5 max|logit|), whether they are bit-equal, the
     launches a request equal to the live path's at every size, export
     and load seconds, artifact MB, ms and img/s of both paths;
 27. phase 24's fleet (16 members, 4 u x 4 seeds) under the Evaluate
     notebook's switch[0.6,0.4] and solver_ens[0.6,0.4] (ensemble_prob 1)
     over two noised RK2 solvers (the grid's model-ensembling pair around
     u=0.5, shifted to each member's u), each member drawing from its own
     generator: finite losses, the launches a step (switch: a standalone
     step's, B3 51 + 51, B1 32, dgrad 32, wgrad 32, as its members' choices
     share one solve on their stacked tableau; solver_ens: one more solve's
     worth each way, B1 32, dgrad 32, wgrad 32, B3 48 + 48), a warm-up and
     five timed steps beside phase 24's standalone fleet, each member
     against its single run over two steps from one state with its draws
     (cuDNN deterministic, as in 24)
     (phase 24's bars), the fleet's kernel path against its plain path
     (phase 11's bars); then a fleet of four (one a u) under Adam 1e-3
     with the non-finite backoff 0.5 and skip_nonfinite, member 1's batch
     NaN at step 0 of three: each member's count, scale and n_skipped equal
     its single run's, its params within phase 24's bars of them;
 28. the three ``examples/torch`` scripts as subprocesses on the card (their
     default device), run together: MNIST on the shipped checkpoint in the
     port's format (``examples/checkpoints/mnist_digits_smoothing_torch``),
     CIFAR at in_planes 64, batch 256, 512 images, bf16, all four regimes,
     and the coefficient example at its default 400 steps; each exits 0;
     their accuracies, u, launches and wall seconds; the MNIST example's
     clean accuracy equal to the port's in-process ``accuracy`` on the same
     images.
 29. the ensemble on the member axis: four members of
     ``solver_ensemble_by_noising`` (RK2 u=0.5, 8 steps, Normal(0.2)) through
     ``accuracy_ensemble`` and ``adversarial_accuracy_ensemble`` (FGSM) with
     a one-rank ``ensemble`` mesh beside the member loop, the MNIST
     MetaNODE (dim 64, f32) and premetanode10 (in_planes 64, bf16), two
     batches of 256: averaged probabilities within 1e-5 (f32) or 2^-5
     (bf16) of the loop's and of the plain path's, exact launches a batch
     (B1, its dgrad, B3 and its backward once for all members where the
     loop launches them once a member; B2 once a member either way), the
     accuracies and ms a batch both ways;
 30. data parallelism, as subprocesses on the one card: (a)
     ``mnist_runner --mesh data=1`` on a one-rank NCCL group against the
     same run without ``--mesh`` (dim 64, batch 128, SGD lr 0.05, 2
     epochs on 1280 synthetic images): epoch losses and final params bit
     for bit, launches equal (cuDNN on its deterministic algorithms); (b)
     the run as two gloo ranks sharing the card (NCCL refuses two ranks on
     one device) against one process over two epochs of one batch: step
     1's loss within 2e-5, step 2's within 1e-3 and at most 1e-2 of the
     params more than 1e-4 max|p| apart (phase 24's bars over its two
     steps), each rank's launches the one process's; the 20-step pair
     printed beside a witness (the one-process run with cuDNN's default,
     atomic-ordered algorithms); (d) phase 29's MNIST
     ensemble over an ``ensemble`` axis of two gloo ranks against the
     one-rank result; (c) phase 9's flagship step at batch 256 as two
     ranks of 128: one f32 step's reduced gradient within 1e-4 max|g| of
     one process's (clean, smoothing kept), three bf16 steps timed with
     the all-reduce's ms a step per rank beside one process's step, each
     rank launching phase 9's step;
 31. tensor, spatial and pipeline parallelism, as two gloo ranks sharing
     the card against one process: the flagship recipe (f32, batch 256,
     cuDNN deterministic) over (a) ``data=1,model=2``, (b) ``data=1,sp=2``
     and (c) ``data=1,pp=2`` with ``num_blocks ((1,2),(1,2))`` at 2 and 4
     microbatches (batch 128: two ranks of its f32 step at 256 do not fit
     the card beside the parent): step 1's loss within 2e-5, step 2's within 1e-3 and at
     most 1e-2 of the params more than 1e-4 max|p| apart (phase 24's
     bars), each rank's launches a step exactly ``mesh_per_step``'s, and
     one bf16 step a rank timed beside one process's; (a) also a no-grad
     exact-GELU eval on the local channels (B1 4 + 64, no B2) against the
     unsharded model on B2 within 1e-4 max|logit|; (c) also the switch
     regime's logits and a no-grad exact-GELU eval (B2 once a microbatch)
     against the sequential model within 1e-6; (d) ``cifar_runner --mesh
     data=1,pp=2`` for one epoch, then ``--resume`` for one more: two
     checkpoints, two finite epoch losses.  Phases 3-4 hold and time B1,
     its dgrad and its wgrad at the shapes these axes give them.
Then one JSON line of per-kernel numbers and, last, the result line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.  Without a
CUDA device, or outside a checkout of the repository, it exits non-zero
and prints no result.  Besides the kernels it builds (and the data
library, built with g++ into the package's ``_build_out/``), it writes
files only under temporary directories that phases 15-17, 19, 22, 25, 26,
30 and 31 delete at their end (and ``u_sweep``'s log, ``u_sweep.log``, in the
working directory).
"""
import contextlib
import copy
import json
import math
import os
import re
import subprocess
import sys
import time
from collections import Counter

REPO = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet, dense rates at 700 W):
# bytes/s of HBM3, FLOP/s by operand type (f32 outside the tensor cores).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

BATCH = 256
N_STEPS = 8
U = 0.5
REQUEST_ROUNDS = 5  # counted requests per served batch size
TRAIN_STEPS = 5  # counted train steps
B2_LAUNCHES_PER_SOLVE = 4 * N_STEPS + 1  # GELU of y0, then 4 convs a step

# (name, N, H, W, Cin, Cout): every B1 call of one request at batch 256
B1_CALLS = [
    ("stem 3->64", BATCH, 32, 32, 3, 64),
    ("layer1 conv1 64->64", BATCH, 32, 32, 64, 64),
    ("layer1 conv2 64->64", BATCH, 32, 32, 64, 64),
    ("layer2 conv2 128->128", BATCH, 16, 16, 128, 128),
]
# (name, N, H, W, C): every B2 solve of one request at batch 256
B2_CALLS = [
    ("layer1 ode (256,32,32,64)", BATCH, 32, 32, 64),
    ("layer2 ode (256,16,16,128)", BATCH, 16, 16, 128),
]

# The MNIST MetaNODE (dim 64, RK2 u=0.5, 8 steps: 16 ODEfunc calls per
# request), served in f32.  (name, N, H, W, Cin, Cout, launches per request)
MNIST_DIM = 64
MNIST_RHS = 2 * N_STEPS
B1_MNIST_CALLS = [
    ("ODEfunc ConcatConv2d 65->64", BATCH, 6, 6, MNIST_DIM + 1, MNIST_DIM,
     2 * MNIST_RHS),
]
# (name, N, H, W, C, act, launches per request), all with 32 groups
B3_OFF_PATH = [
    ("off the served paths", BATCH, 32, 32, MNIST_DIM, "relu", 0),
]
B3_CALLS = [
    ("down norm0 + relu", BATCH, 26, 26, MNIST_DIM, "relu", 1),
    ("down norm1 + relu", BATCH, 13, 13, MNIST_DIM, "relu", 1),
    ("ODEfunc norm1/norm2 + relu, head norm + relu", BATCH, 6, 6, MNIST_DIM,
     "relu", 2 * MNIST_RHS + 1),
    ("ODEfunc norm3", BATCH, 6, 6, MNIST_DIM, None, MNIST_RHS),
]
GN_GROUPS = 32
GN_OPS_PER_ELEMENT = 10  # sum, centred square, normalize, affine, act
# B3's backward: two stats passes, xhat, y, act', two sums, dx
GN_BWD_OPS_PER_ELEMENT = 30

# The digits recipe (scripts/digits_smoothing_experiment.py:81-140): the
# MNIST MetaNODE at dim 64, RK2 u=0.5 8 steps, Normal(0.0125) smoothing,
# PGD at eps 0.3, lr 2/255, 7 iterations with a random start, RMSprop lr
# 1e-3, weight decay 5e-4, f32; trained at batch 128, evaluated at 256.
MNIST_TRAIN_BATCH = 128
EVAL_BATCH = 256
EVAL_BATCHES = 4
PGD_EPS, PGD_LR, PGD_ITERS = 0.3, 2 / 255, 7
MNIST_GN_PER_PASS = sum(c[-1] for c in B3_CALLS)  # 51
MNIST_B1_PER_PASS = sum(c[-1] for c in B1_MNIST_CALLS)  # 32
# B3's backward at the train step's shapes: (name, N, H, W, C, act,
# launches per backward pass); off the path at (256, 32, 32, 64)
B3_BWD_CALLS = [(nm, MNIST_TRAIN_BATCH, h, w, c, act, k)
                for nm, _, h, w, c, act, k in B3_CALLS]
B3_BWD_OFF_PATH = [("off the path", BATCH, 32, 32, MNIST_DIM, "relu", 0)]
TRAIN_MNIST = (MNIST_TRAIN_BATCH, 6, 6, MNIST_DIM + 1, MNIST_DIM)
# a train step: PGD_ITERS attack passes (forward, then the input's
# backward) and the training pass (forward, then the params' backward)
MNIST_TRAIN_PER_STEP = {
    "group_norm_act": (PGD_ITERS + 1) * MNIST_GN_PER_PASS,
    "conv3x3_same": (PGD_ITERS + 1) * MNIST_B1_PER_PASS,
    "group_norm_act_bwd": (PGD_ITERS + 1) * MNIST_GN_PER_PASS,
    "group_norm_act_bwd_params": MNIST_GN_PER_PASS,
    "conv3x3_dgrad": (PGD_ITERS + 1) * MNIST_B1_PER_PASS,
    "conv3x3_wgrad": MNIST_B1_PER_PASS,
}
# an eval batch: clean, one forward; PGD, PGD_ITERS attack passes and the
# forward of the attacked batch
# the regime table's MNIST bar on the share of input gradients more than
# 1e-3 of their max apart between the kernel and the plain path (phase 13)
MNIST_GRAD_FAR_BAR = 1e-2
EVAL_CLEAN_PER_BATCH = {"group_norm_act": MNIST_GN_PER_PASS,
                        "conv3x3_same": MNIST_B1_PER_PASS}
EVAL_PGD_PER_BATCH = {
    "group_norm_act": (PGD_ITERS + 1) * MNIST_GN_PER_PASS,
    "conv3x3_same": (PGD_ITERS + 1) * MNIST_B1_PER_PASS,
    "group_norm_act_bwd": PGD_ITERS * MNIST_GN_PER_PASS,
    "conv3x3_dgrad": PGD_ITERS * MNIST_B1_PER_PASS,
}

# The flagship train step at batch 256: forward convs (N, H, W, Cin, Cout)
# of B1 and their launches per step.  A pass runs 68: the stem, layer 1's
# res block (2), layer 2's stride-1 res conv (1) and 2 ODE blocks x 8 steps
# x 2 stages x 2 convs (64); the attack pass and the training pass.  The
# dgrad of the stem is a 64 -> 3 conv and runs in the attack pass only (the
# training pass's input is detached); the wgrad runs in the training pass
# only (the attack's weights are detached).
TRAIN_STEM = (BATCH, 32, 32, 3, 64)
TRAIN_L1 = (BATCH, 32, 32, 64, 64)
TRAIN_L2 = (BATCH, 16, 16, 128, 128)
TRAIN_FWD = {TRAIN_STEM: 2, TRAIN_L1: 68, TRAIN_L2: 66}
TRAIN_DGRAD = {TRAIN_STEM: 1, TRAIN_L1: 68, TRAIN_L2: 66}
TRAIN_WGRAD = {TRAIN_STEM: 1, TRAIN_L1: 34, TRAIN_L2: 33}
B1_TRAIN_PER_STEP = {"conv3x3_same": sum(TRAIN_FWD.values()),
                     "conv3x3_dgrad": sum(TRAIN_DGRAD.values()),
                     "conv3x3_wgrad": sum(TRAIN_WGRAD.values())}
# GeLUpoly (ops/gelu_poly.py) a premetanode10 pass: the stem's bn1, the two
# res blocks' two (layer 2's first before its stride-2 conv, at 32x32x64)
# and two an RHS call (16 calls a block); in a step both passes
# differentiate every call
GELU_POLY_CALLS = {(BATCH, 32, 32, 64): 1 + 3 + 32,
                   (BATCH, 16, 16, 128): 1 + 32}
GELU_POLY_PASS = sum(GELU_POLY_CALLS.values())  # 69
TRAIN_PER_STEP = {**B1_TRAIN_PER_STEP, "gelu_poly": 2 * GELU_POLY_PASS,
                  "gelu_poly_bwd": 2 * GELU_POLY_PASS}
# JAX data/datasets.py:43-44
CIFAR10_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR10_STD = (0.2023, 0.1994, 0.2010)

# The Evaluate-notebook regime table (training/evaluate.py::
# notebook_regime_grid: standalone, switch[0.6,0.4] over u in {0.5, 1.0},
# solver_ens[0.6,0.4] at ensemble_prob 1, model ensembling of two
# Normal(0.2)-noised solvers), clean and FGSM: the MNIST MetaNODE at eps 0.3
# with the step-count sweep of scripts/digits_regimes_eval.py:83-176, and
# premetanode10 in bf16 at eps 8/255 (scripts/replicate_baseline.py).
MNIST_FGSM_EPS = 0.3
SWEEP = (1, 2, 4, 8)
CIFAR_EVAL_BATCHES = 2
# a regime's model forwards and ODE solves a forward: switch takes one
# branch; solver_ens at ensemble_prob 1 integrates both solvers; model
# ensembling runs the model once a member
REGIME_MODELS = {"standalone": 1, "switch": 1, "solver_ens": 1,
                 "model_ensembling": 2}
REGIME_SOLVES = {"standalone": 1, "switch": 1, "solver_ens": 2,
                 "model_ensembling": 2}


def mnist_forward_counts(kind, n):
    """Launches of one MNIST forward at n steps, with or without a
    gradient: B3 three GroupNorms outside the ODE block a model, three an
    RHS call; B1 two an RHS call (two RHS calls a step)."""
    return {"group_norm_act": 3 * REGIME_MODELS[kind]
            + 6 * n * REGIME_SOLVES[kind],
            "conv3x3_same": 4 * n * REGIME_SOLVES[kind]}


def cifar_forward_counts(kind, n, b2=True):
    """Launches of one premetanode10 forward at n steps: four B1 convs
    outside the ODE blocks a model; an ODE block is B2 (4n + 1 launches)
    where it may take it (standalone, no gradient: ``b2``), else 4n B1
    convs a solve."""
    models, solves = REGIME_MODELS[kind], REGIME_SOLVES[kind]
    if b2 and kind in ("standalone", "model_ensembling"):
        return {"conv3x3_same": 4 * models,
                "ode_block_rk2": 2 * (4 * n + 1) * models}
    return {"conv3x3_same": 4 * models + 2 * 4 * n * solves}


def argmax_apart(scores, ref):
    """``(moved, near)``: rows whose argmax differs between ``scores`` and
    ``ref`` although ``ref``'s top two are more than twice the largest
    difference of the two apart, and the rows where they are not (near
    ties, whose argmax rounding may move: bf16 flips them)."""
    d = (scores - ref).abs().max()
    top2 = ref.topk(2, dim=-1).values
    near = top2[:, 0] - top2[:, 1] <= 2 * d
    moved = scores.argmax(-1) != ref.argmax(-1)
    return int((moved & ~near).sum()), int(near.sum())


def member_logits_apart(model, solvers, x, logit_bar):
    """``[(max|diff|, bar)]``: each model-ensemble member's logits on
    ``x``, kernel path against plain path, and ``logit_bar`` of the plain
    path's logits."""
    import torch

    out = []
    with torch.inference_mode():
        for s in solvers:
            lk, lp = (model(x, [s], use_kernels=uk).float()
                      for uk in (True, False))
            out.append(((lk - lp).abs().max().item(), logit_bar(lp)))
    return out


def member_forwards(model, spec, use_kernels, seed, f64=False):
    """The forwards ``x_normalized -> logits`` of the regime ``spec``'s
    members (one but for model ensembling) on detached weights, every
    forward's regime draws from ``seed``; ``f64`` runs the plain path in
    f64 (on a copy of the model)."""
    import torch

    from neural_ode_metasolver_tpu_torch.ops import SolverOptions

    if f64:
        model, use_kernels = copy.deepcopy(model).double(), False
    frozen = model.detached_params()
    members = ([([s], SolverOptions()) for s in spec.solvers]
               if spec.is_model_ensemble
               else [(list(spec.solvers), spec.options)])
    return [lambda xi, sv=sv, o=o: model(
                xi.double() if f64 else xi, sv, o,
                use_kernels=use_kernels, params=frozen,
                generator=torch.Generator().manual_seed(seed))
            for sv, o in members]


def fgsm_apart(paths, x, y, eps, mean=None, std=None):
    """One batch's FGSM through each of ``paths`` with TF32 off.  A path is
    a list of member forwards ``x_normalized -> logits``: one member takes
    ``fgsm``, several ``fgsm2ensemble``'s joint step, as the entry points
    do.  For each path after the first, how far it lies from the first:
    x_adv's pixels apart (``differ``, their share ``share``, and ``worst``,
    the largest input gradient among them as a share of the max) and the
    input gradients of the members' mean-softmax NLL (``grad_err``, the
    largest difference, and ``grad_far``, the share of them more than 1e-3
    apart, both of the first path's max)."""
    import torch

    from neural_ode_metasolver_tpu_torch.attacks import (
        fgsm,
        fgsm2ensemble,
        inv_normalize,
        normalize,
    )
    from neural_ode_metasolver_tpu_torch.backend import full_f32

    xas, grads = [], []
    with full_f32(), torch.enable_grad():
        for fwds in paths:
            xas.append((fgsm2ensemble(fwds, x, y, eps, mean, std)
                        if len(fwds) > 1 else
                        fgsm(fwds[0], x, y, eps, mean, std))[0])
            x01 = inv_normalize(x, mean, std).requires_grad_(True)
            p = sum(torch.softmax(f(normalize(x01, mean, std)), -1)
                    for f in fwds) / len(fwds)
            grads += torch.autograd.grad(
                -torch.log(p).gather(-1, y[:, None]).mean(), x01)
    scale = grads[0].abs().max()
    out = []
    for xa, g in zip(xas[1:], grads[1:]):
        differ = xa != xas[0]
        gap = (g - grads[0]).abs() / scale
        out.append(dict(
            differ=int(differ.sum()), share=differ.float().mean().item(),
            worst=(grads[0].abs()[differ].max() / scale).item()
            if bool(differ.any()) else 0.0,
            grad_err=gap.max().item(),
            grad_far=(gap > 1e-3).float().mean().item()))
    return out


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(msg):
    print(f"== {msg}", flush=True)


# Phases 15-17: the CLIs.  Phase 15 is the digits recipe through
# mnist_runner (as phase 11, synthetic data; validation and the PGD-7 test
# each one batch of the 512 test images), phase 16 the flagship recipe
# through cifar_runner (as phase 9; 2816 synthetic images, of which 281
# validate in two batches, and a PGD-7 test over 512 in two batches).
RUNNER_MNIST_TRAIN, RUNNER_MNIST_TEST = 1280, 512
RUNNER_MNIST_EPOCHS, RUNNER_MNIST_RESUME_EPOCHS = 2, 3
RUNNER_MNIST_STEPS = RUNNER_MNIST_TRAIN // MNIST_TRAIN_BATCH  # an epoch
RUNNER_CIFAR_TRAIN, RUNNER_CIFAR_TEST = 2816, 512
RUNNER_CIFAR_VAL = int(math.floor(0.1 * RUNNER_CIFAR_TRAIN))  # --val_perc
RUNNER_CIFAR_STEPS = (RUNNER_CIFAR_TRAIN - RUNNER_CIFAR_VAL) // BATCH
# two epochs: the first one's batch_time carries the run's first step
# (allocations after the earlier phases emptied the cache; phase 9's
# warm-up step is about 0.9 s), the second is the steady state
RUNNER_CIFAR_EPOCHS = 2
# a premetanode10 pass under GeLUpoly runs B1 68 times (no B2); a PGD
# batch is PGD_ITERS attack passes (forward and the input's backward) and
# the forward of the attacked batch
CIFAR_PASS_B1 = sum(TRAIN_FWD.values()) // 2
CIFAR_PGD_PER_BATCH = {"conv3x3_same": (PGD_ITERS + 1) * CIFAR_PASS_B1,
                       "conv3x3_dgrad": PGD_ITERS * CIFAR_PASS_B1,
                       "gelu_poly": (PGD_ITERS + 1) * GELU_POLY_PASS,
                       "gelu_poly_bwd": PGD_ITERS * GELU_POLY_PASS}


# Phase 18: metanode10 (the basic-block family) with GroupNorm of 32 groups
# in every slot and the exact GELU, which B3 fuses, under the flagship
# recipe of phase 9 at batch 256 in bf16.  A pass runs B1 68 times, as
# phase 9's, and B3 70 times: (name, N, H, W, C, act, launches a pass) --
# the stem's bn1, layer 1's res block (bn1 with the GELU, bn2 without), an
# RHS call's two norms (16 calls a block) and layer 2's res block (bn1,
# bn2 and the shortcut's norm).
GN_NET = dict(in_planes=64, norms=("GN",) * 3, num_gn_groups=GN_GROUPS)
B3_CIFAR_CALLS = [
    ("stem bn1, layer1 res bn1, layer1 RHS norms + gelu", BATCH, 32, 32, 64,
     "gelu", 2 + 4 * N_STEPS),
    ("layer1 res bn2", BATCH, 32, 32, 64, None, 1),
    ("layer2 res bn1, layer2 RHS norms + gelu", BATCH, 16, 16, 128, "gelu",
     1 + 4 * N_STEPS),
    ("layer2 res bn2, shortcut norm", BATCH, 16, 16, 128, None, 2),
]
GN_PASS_B3 = sum(c[-1] for c in B3_CIFAR_CALLS)  # 70
# Phase 20: metanode18 with the same GroupNorms: metanode10's two stages
# and two more like its second at 256 channels 8x8 and 512 at 4x4, each
# adding B1 33 a pass (the res block's stride-1 conv2, the ODE block's 32)
# and B3 35 (rows as above); the wide rows also run in phases 6 and 6b
B3_WIDE_CALLS = [
    ("layer3 res bn1, layer3 RHS norms + gelu", BATCH, 8, 8, 256, "gelu",
     1 + 4 * N_STEPS),
    ("layer3 res bn2, shortcut norm", BATCH, 8, 8, 256, None, 2),
    ("layer4 res bn1, layer4 RHS norms + gelu", BATCH, 4, 4, 512, "gelu",
     1 + 4 * N_STEPS),
    ("layer4 res bn2, shortcut norm", BATCH, 4, 4, 512, None, 2),
]
M18_PASS_B1 = sum(TRAIN_FWD.values()) // 2 + 2 * 33  # 134
M18_PASS_B3 = GN_PASS_B3 + sum(c[-1] for c in B3_WIDE_CALLS)  # 140
M18_TRAIN_PER_STEP = {"conv3x3_same": 2 * M18_PASS_B1,
                      "conv3x3_dgrad": 2 * M18_PASS_B1 - 1,  # no stem dgrad
                      "conv3x3_wgrad": M18_PASS_B1,           # in training
                      "group_norm_act": 2 * M18_PASS_B3,
                      "group_norm_act_bwd": 2 * M18_PASS_B3,
                      "group_norm_act_bwd_params": M18_PASS_B3}
M18_TRAIN_STEPS = 1  # counted steps after the warm-up
# a step: the attack pass's backward is dx only, the training pass's also
# gives dscale and dbias
GN_TRAIN_PER_STEP = {**B1_TRAIN_PER_STEP, "group_norm_act": 2 * GN_PASS_B3,
                     "group_norm_act_bwd": 2 * GN_PASS_B3,
                     "group_norm_act_bwd_params": GN_PASS_B3}
# Phase 19: the model state through cifar_runner: premetanode10 with BN in
# the res blocks and bn1, SN in the res and ODE blocks, the orthogonal init
# (B1 68 a pass: no B2, since the ODE blocks' SN leaves B2's RHS; no B3)
FAMILY_ARGV = ["--network", "premetanode10", "--in_planes", "64",
               "--normalization_resblock", "BN", "--normalization_bn1", "BN",
               "--param_normalization_resblock", "SN",
               "--param_normalization_odeblock", "SN", "--init",
               "orthogonal"]
FAMILY_TRAIN = 570  # 57 validate (one batch), 513 train: 2 steps an epoch
FAMILY_VAL = int(math.floor(0.1 * FAMILY_TRAIN))
FAMILY_STEPS = (FAMILY_TRAIN - FAMILY_VAL) // BATCH
FAMILY_EPOCHS = 2
# ResNet-10 (metanode10 --is_odenet False) with GN: a clean batch runs B1 8
# times (the stem, layer 1's four convs, layer 2's three stride-1 convs) and
# B3 10 times (the stem's bn1, two norms a block, the shortcut's norm)
RESNET10_PER_BATCH = {"conv3x3_same": 8, "group_norm_act": 10}
# Phase 21: the flagship step under the continuous adjoint.  Each pass runs
# its 68 forward convs, and its backward recomputes every RK stage's RHS of
# the two ODE blocks (2 blocks x 8 steps x 2 stages x 2 convs = 64) before
# differentiating it; dgrad and wgrad run as under backprop
ADJ_ODE_RECOMPUTE = 2 * N_STEPS * 2 * 2
ADJ_TRAIN_PER_STEP = {**TRAIN_PER_STEP, "conv3x3_same": TRAIN_PER_STEP[
    "conv3x3_same"] + 2 * ADJ_ODE_RECOMPUTE,  # 264
    # the recomputed RHS calls' GeLUpoly, two a call as their convs
    "gelu_poly": TRAIN_PER_STEP["gelu_poly"] + 2 * ADJ_ODE_RECOMPUTE}
# Phase 22: mnist_runner --train_solver_params, the digits recipe's flags
# (the joint loop, as JAX's, takes neither smoothing nor a PGD test): an
# epoch is 10 steps of phase 11's launches and one clean validation batch
SOLVER_LR_UV = 0.01
SOLVER_EPOCHS = 2
# u's gradient in f32, either path, against the plain path's in f64: f32
# rounding alone reads 2.49e-3 on the plain path (H100, phase 22)
SOLVER_DU_BAR = 1e-2


def scaled(counts, k):
    return Counter({name: v * k for name, v in counts.items()})


def read_metrics(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def check_checkpoint_dir(path):
    """A checkpoint base holds a committed step with its sidecar."""
    steps = sorted(d for d in os.listdir(path) if d.startswith("step_")) \
        if os.path.isdir(path) else []
    if not steps or not all(
            os.path.isfile(os.path.join(path, d, f))
            for d in steps for f in ("state", "config.json")):
        fail(f"{path}: no committed step with its sidecar ({steps})")
    return steps


def digits_runner_argv(save_dir):
    """mnist_runner's flags for the digits recipe of phase 15."""
    return ["--solvers", f"rk2,u,{N_STEPS},-1,{U},-1",
            "--adv_training_mode", "at", "--eps_adv_training",
            str(PGD_EPS), "--pgd_lr_training", str(PGD_LR),
            "--pgd_niter_training", str(PGD_ITERS),
            "--noise_type", "normal", "--noise_sigma", "0.0125",
            "--noise_prob", "1.0", "--optim", "rmsprop", "--lr",
            "1e-3", "--weight_decay", "5e-4", "--batch_size",
            str(MNIST_TRAIN_BATCH), "--adv_testing_mode", "at",
            "--eps_adv_testing", str(PGD_EPS), "--pgd_lr_testing",
            str(PGD_LR), "--pgd_niter_testing", str(PGD_ITERS),
            "--synthetic_train_size", str(RUNNER_MNIST_TRAIN),
            "--synthetic_test_size", str(RUNNER_MNIST_TEST),
            "--save_dir", save_dir]


def runner_phases(port, torch, dev, bare_flagship_ms, bare_mnist_ms):
    """Phases 15-17: the three CLIs at full width, under a temporary
    directory that is deleted at the end.  Returns the launches of the
    phases' runs."""
    import argparse
    import tempfile

    from neural_ode_metasolver_tpu_torch.data import (
        batch_iterator,
        synthetic_dataset,
    )
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
    from neural_ode_metasolver_tpu_torch.runners import (
        attacks_runner,
        cifar_runner,
        common,
        mnist_runner,
    )
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        create_train_state,
        make_adversarial_predict,
        restore_checkpoint,
    )

    totals = Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runners_") as tmp:
        # ------------------------------------------------ 15 mnist_runner
        phase(f"mnist_runner: the digits recipe (dim {MNIST_DIM}, PGD-"
              f"{PGD_ITERS}, smoothing, RMSprop), f32, batch "
              f"{MNIST_TRAIN_BATCH}, {RUNNER_MNIST_EPOCHS} epochs of "
              f"{RUNNER_MNIST_STEPS} steps, then --resume")
        msave = os.path.join(tmp, "mnist")
        margv = digits_runner_argv(msave)
        per_epoch = (scaled(MNIST_TRAIN_PER_STEP, RUNNER_MNIST_STEPS)
                     + Counter(EVAL_CLEAN_PER_BATCH)
                     + Counter(EVAL_PGD_PER_BATCH))
        port.reset_launch_counts()
        t0 = time.perf_counter()
        ts = mnist_runner.main(margv + ["--nepochs",
                                        str(RUNNER_MNIST_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = port.launch_counts()
        totals += Counter(got)
        recs = read_metrics(msave)
        epochs = [r for r in recs if "train_loss" in r]
        with open(os.path.join(msave, "logs")) as f:
            log = f.read()
        backend = "native" if "data backend: native" in log else "numpy"
        for r in epochs:
            print(f"  epoch {int(r['epoch'])}: train loss "
                  f"{r['train_loss']:.6f}, batch_time "
                  f"{r['batch_time'] * 1e3:.3f} ms = "
                  f"{MNIST_TRAIN_BATCH / r['batch_time']:.1f} img/s, "
                  f"{r['batch_time'] * RUNNER_MNIST_STEPS:.3f} s of steps "
                  f"(phase 11's bare step: {bare_mnist_ms:.3f} ms)",
                  flush=True)
        print(f"  {wall:.3f} s for {RUNNER_MNIST_EPOCHS} epochs with "
              f"validation, PGD-{PGD_ITERS} test and checkpoints "
              f"({wall / RUNNER_MNIST_EPOCHS:.3f} s an epoch); data "
              f"backend {backend}; adversarial test "
              f"{[r['adv_test_acc'] for r in recs if 'adv_test_acc' in r]}",
              flush=True)
        want = dict(scaled(per_epoch, RUNNER_MNIST_EPOCHS))
        print(f"  launches {got} (expected {want}: per epoch "
              f"{RUNNER_MNIST_STEPS} x phase 11's step, one validation "
              f"batch and one PGD-{PGD_ITERS} batch)", flush=True)
        losses = [r["train_loss"] for r in epochs]
        if len(epochs) != RUNNER_MNIST_EPOCHS or not all(
                math.isfinite(v) for v in losses):
            fail(f"mnist_runner: epoch losses {losses}")
        if backend != "native":
            fail("mnist_runner: the data backend is not native")
        if got != want:
            fail(f"mnist_runner: launches {got} != expected {want}")
        if recs[0].get("_type") != "config" or ts.step != \
                RUNNER_MNIST_EPOCHS * RUNNER_MNIST_STEPS:
            fail(f"mnist_runner: metrics {recs[0].get('_type')}, step "
                 f"{ts.step}")
        last_steps = check_checkpoint_dir(os.path.join(msave, "last"))
        check_checkpoint_dir(os.path.join(msave, "best_solver_0"))
        saved = torch.load(os.path.join(msave, "last", last_steps[-1],
                                        "state"), map_location="cpu",
                           weights_only=True)

        # --resume: the restored state against the saved file, bit for bit
        restored = {}
        real_restore = common.restore_checkpoint

        def spy(base, target):
            out, cfg = real_restore(base, target)
            restored["step"] = out.step
            restored["params"] = {k: v.detach().cpu().clone()
                                  for k, v in out.params.items()}
            restored["opt"] = {k: ({n: t.detach().cpu().clone()
                                    for n, t in v.items()}
                                   if isinstance(v, dict) else v)
                               for k, v in out.opt_state.items()}
            return out, cfg

        common.restore_checkpoint = spy
        try:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            # the resumed run copies each batch in the step (--prefetch
            # 0): its batch_time against the first run's shows what the
            # prefetch thread costs or saves on this host-bound step
            ts = mnist_runner.main(margv + [
                "--nepochs", str(RUNNER_MNIST_RESUME_EPOCHS), "--resume",
                "--prefetch", "0"])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            common.restore_checkpoint = real_restore
        got = port.launch_counts()
        totals += Counter(got)
        same = (restored.get("step") == saved["step"]
                and restored["params"].keys() == saved["params"].keys()
                and all(torch.equal(restored["params"][k], v)
                        for k, v in saved["params"].items())
                and restored["opt"].keys() == saved["opt_state"].keys()
                and all((restored["opt"][k].keys() == v.keys() and all(
                    torch.equal(restored["opt"][k][n], t)
                    for n, t in v.items())) if isinstance(v, dict)
                    else restored["opt"][k] == v
                    for k, v in saved["opt_state"].items()))
        recs = [r for r in read_metrics(msave) if "train_loss" in r]
        steps = [int(r["step"]) for r in recs]
        want = dict(scaled(per_epoch, RUNNER_MNIST_RESUME_EPOCHS))
        print(f"  --resume --nepochs {RUNNER_MNIST_RESUME_EPOCHS}: restored "
              f"step {restored.get('step')} from {last_steps[-1]}, params "
              f"and optimizer state bit for bit: {same}; epoch steps "
              f"{steps}; {wall:.3f} s; batch_time without the prefetch "
              f"{[round(r['batch_time'] * 1e3, 3) for r in recs[-3:]]} ms "
              f"(with it {[round(r['batch_time'] * 1e3, 3) for r in recs[:2]]}"
              f"); launches {got} (expected {want})", flush=True)
        first = RUNNER_MNIST_EPOCHS * RUNNER_MNIST_STEPS
        if not same or restored.get("step") != first:
            fail("mnist_runner --resume: the restored state differs from "
                 "the saved one")
        if steps[RUNNER_MNIST_EPOCHS:] != [
                first + RUNNER_MNIST_STEPS * (e + 1)
                for e in range(RUNNER_MNIST_RESUME_EPOCHS)]:
            fail(f"mnist_runner --resume: epoch steps {steps}")
        if got != want:
            fail(f"mnist_runner --resume: launches {got} != {want}")

        # ------------------------------------------------ 16 cifar_runner
        phase(f"cifar_runner: the flagship recipe (premetanode10, in_planes "
              f"64, GeLUpoly, FGSM-random, smoothing, SGD), bf16, batch "
              f"{BATCH}, {RUNNER_CIFAR_EPOCHS} epochs of {RUNNER_CIFAR_STEPS} "
              f"steps, PGD-{PGD_ITERS} test")
        csave = os.path.join(tmp, "cifar")
        cargv = ["--network", "premetanode10", "--in_planes", "64",
                 "--activation_resblock", "GeLUpoly",
                 "--activation_odeblock", "GeLUpoly",
                 "--activation_bn1", "GeLUpoly",
                 "--solvers", f"rk2,u,{N_STEPS},-1,{U},-1",
                 "--adv_training_mode", "fgsm_random",
                 "--eps_adv_training", str(8 / 255),
                 "--fgsm_random_step_size_training", str(10 / 255),
                 "--noise_type", "normal", "--noise_sigma", "0.0125",
                 "--noise_prob", "1.0", "--optim", "sgd",
                 "--precision", "bf16", "--batch_size", str(BATCH),
                 "--synthetic_train_size", str(RUNNER_CIFAR_TRAIN),
                 "--synthetic_test_size", str(RUNNER_CIFAR_TEST),
                 "--adv_testing_mode", "at", "--test_batch_size",
                 str(BATCH), "--nepochs", str(RUNNER_CIFAR_EPOCHS),
                 "--save_dir", csave]
        n_val = -(-RUNNER_CIFAR_VAL // BATCH)
        n_test = -(-RUNNER_CIFAR_TEST // BATCH)
        want = dict(scaled(
            scaled(TRAIN_PER_STEP, RUNNER_CIFAR_STEPS)
            + Counter({"conv3x3_same": CIFAR_PASS_B1 * n_val,
                       "gelu_poly": GELU_POLY_PASS * n_val})
            + scaled(CIFAR_PGD_PER_BATCH, n_test), RUNNER_CIFAR_EPOCHS))
        # the runner's PGD-7 test (f32, as the JAX runner evaluates),
        # timed through the runner
        pgd_s = []
        real_adv = common.adversarial_accuracy

        def timed_adv(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = real_adv(*a, **kw)
            torch.cuda.synchronize()
            pgd_s.append(time.perf_counter() - t)
            return out

        common.adversarial_accuracy = timed_adv
        port.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            ts = cifar_runner.main(cargv)
            torch.cuda.synchronize()
        finally:
            common.adversarial_accuracy = real_adv
        wall = time.perf_counter() - t0
        got = port.launch_counts()
        totals += Counter(got)
        recs = read_metrics(csave)
        ep = [r for r in recs if "train_loss" in r]
        for r in ep:
            print(f"  epoch {int(r['epoch'])}: train loss "
                  f"{r['train_loss']:.6f}, batch_time "
                  f"{r['batch_time'] * 1e3:.3f} ms a step = "
                  f"{BATCH / r['batch_time']:.1f} img/s (phase 9's bare "
                  f"step: {bare_flagship_ms:.3f} ms)", flush=True)
        print(f"  {wall:.3f} s for {RUNNER_CIFAR_EPOCHS} epochs with "
              f"validation ({n_val} batches), the PGD-{PGD_ITERS} test "
              f"({n_test} batches) and checkpoints; adversarial test "
              f"{[r['adv_test_acc'] for r in recs if 'adv_test_acc' in r]}",
              flush=True)
        print(f"  PGD-{PGD_ITERS} test through the runner in f32: "
              f"{[round(v * 1e3 / n_test, 3) for v in pgd_s]} ms a batch of "
              f"{BATCH} by epoch", flush=True)
        if len(pgd_s) != RUNNER_CIFAR_EPOCHS:
            fail(f"cifar_runner: {len(pgd_s)} PGD tests timed")
        print(f"  launches {got} (expected {want}: per epoch "
              f"{RUNNER_CIFAR_STEPS} x phase 9's step, B1 {CIFAR_PASS_B1} "
              f"and GeLUpoly {GELU_POLY_PASS} a validation batch, "
              f"{CIFAR_PGD_PER_BATCH} a PGD batch)",
              flush=True)
        if len(ep) != RUNNER_CIFAR_EPOCHS or not all(
                math.isfinite(r["train_loss"]) for r in ep):
            fail(f"cifar_runner: epoch records {ep}")
        if got != want:
            fail(f"cifar_runner: launches {got} != expected {want}")
        check_checkpoint_dir(os.path.join(csave, "last"))

        # the PGD-7 test batches again, kernel path against plain path,
        # each batch's attack from the same seed
        with open(os.path.join(csave, "last", check_checkpoint_dir(
                os.path.join(csave, "last"))[-1], "config.json")) as f:
            cfg = json.load(f)
        cmodel = cifar_runner.build_cifar_model(cfg["args"], dev)
        restore_checkpoint(os.path.join(csave, "last"), create_train_state(
            cmodel, common.optimizer_from_saved_args(cfg["args"])))
        test_ds = synthetic_dataset(RUNNER_CIFAR_TEST, (32, 32, 3),
                                    seed=602 + 1)
        tbatches = [(torch.as_tensor(x, device=dev),
                     torch.as_tensor(y, device=dev).long())
                    for x, y in batch_iterator(
                        test_ds, BATCH, shuffle=False, drop_last=False,
                        mean=CIFAR10_MEAN, std=CIFAR10_STD)]
        atk = AttackConfig(mode="at", eps=8 / 255, pgd_lr=2 / 255,
                           pgd_niter=PGD_ITERS, mean=CIFAR10_MEAN,
                           std=CIFAR10_STD)
        solvers = parse_solver_dsl(cfg["solvers"])
        pgd_rows = {}
        for use_kernels in (True, False):
            predict = make_adversarial_predict(
                cmodel, solvers, common.build_solver_options(
                    argparse.Namespace(**cfg["args"])), atk,
                compute_dtype=torch.bfloat16, use_kernels=use_kernels)
            predict(*tbatches[0], torch.Generator(device=dev).manual_seed(0))
            ms, correct, preds = [], [], []
            for b, (x, y) in enumerate(tbatches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits = predict(x, y, torch.Generator(
                    device=dev).manual_seed(100 + b))
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                preds.append(logits.argmax(-1))
                correct.append(int((preds[-1] == y).sum()))
            pgd_rows[use_kernels] = (ms, correct, preds)
            path = "kernel" if use_kernels else "plain "
            print(f"  PGD-{PGD_ITERS} bf16 {path} path: ms per batch "
                  f"{[round(m, 3) for m in ms]}, correct per batch "
                  f"{correct} of {[int(y.shape[0]) for _, y in tbatches]}",
                  flush=True)
        apart = [abs(a - b) for a, b in zip(pgd_rows[True][1],
                                            pgd_rows[False][1])]
        # where the attack leaves few samples right the counts say little;
        # the attacked predictions compared one by one say more
        differ = [int((a != b).sum()) for a, b in zip(pgd_rows[True][2],
                                                      pgd_rows[False][2])]
        print(f"  correct counts apart per batch {apart} (bar 2); attacked "
              f"predictions that differ between the paths per batch "
              f"{differ}", flush=True)
        if max(apart) > 2:
            fail(f"cifar_runner's PGD test: kernel and plain paths count "
                 f"{apart} apart in a batch (bar 2)")
        del cmodel, tbatches
        torch.cuda.empty_cache()

        # ---------------------------------------------- 17 attacks_runner
        phase("attacks_runner: clean, FGSM and PGD-7 over the checkpoints "
              "of phases 15 and 16")
        for name, base, eps in (("mnist", msave, PGD_EPS),
                                ("premetanode10", csave, 8 / 255)):
            out = os.path.join(tmp, f"{name}.csv")
            port.reset_launch_counts()
            t0 = time.perf_counter()
            attacks_runner.main([
                "--checkpoints_glob", os.path.join(base, "last"),
                "--modes", "clean,fgsm,at", "--epsilons", str(eps),
                "--pgd_niter", str(PGD_ITERS), "--batch_size", str(BATCH),
                "--output_csv", out])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            totals += Counter(port.launch_counts())
            with open(out) as f:
                lines = f.read().splitlines()
            rows = [dict(zip(lines[0].split(","), l.split(",")))
                    for l in lines[1:]]
            print(f"  {name}: {wall:.3f} s; {lines}", flush=True)
            ok = (lines[0] == "checkpoint,mode,eps,accuracy"
                  and [r["mode"] for r in rows] == ["clean", "fgsm", "at"]
                  and [float(r["eps"]) for r in rows] == [0.0, eps, eps]
                  and all(0.0 <= float(r["accuracy"]) <= 1.0
                          for r in rows))
            if not ok:
                fail(f"attacks_runner {name}: CSV {lines}")
    return totals


def gelu_poly_phase(port, torch, dev, time_ms):
    """Phase 6c: the GeLUpoly kernels against their plain versions at the
    flagship's activation shapes, bf16 and f32, with device and host
    timings (module docstring).  Returns the rows."""
    from neural_ode_metasolver_tpu_torch.ops.gelu_poly import (
        fused_gelu_poly,
        gelu_poly_backward,
        gelu_poly_backward_reference,
        gelu_poly_reference,
    )

    def apart(got, ref32, x, g, dtype):
        """The largest distance to the plain version in f32: bf16 in bf16
        ulps of the f32 result (bar 1), f32 in f32 ulps of |x| forward and
        of (1 + |x|) |g| backward (bar 4); and the share bit-equal to it
        (rounded once, for bf16)."""
        want = ref32.to(dtype).float()
        if dtype == torch.bfloat16:
            unit = torch.ldexp(torch.ones_like(ref32), torch.frexp(ref32)[1]
                               - 8)
        else:
            scale = x.float().abs() if g is None else (
                (1 + x.float().abs()) * g.float().abs())
            unit = 2.0 ** -23 * scale
        d = (got.float() - want).abs()
        ulps = torch.where(d > 0, d / unit, torch.zeros_like(d))
        return ulps.max().item(), (d == 0).float().mean().item()

    def host_us(fn, reps=2000):
        """Host microseconds a call of ``fn`` on a small tensor: the
        wrapper's own cost, the card idle."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        dt = time.perf_counter() - t0
        torch.cuda.synchronize()
        return dt / reps * 1e6

    rows = []
    gen = torch.Generator(device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        for shape, calls in GELU_POLY_CALLS.items():
            gen.manual_seed(60)
            # spread over the clamp's edges, as the card tests
            x = (torch.randn(shape, generator=gen, device=dev) * 4).to(dtype)
            g = torch.randn(shape, generator=gen, device=dev).to(dtype)
            port.reset_launch_counts()
            y = fused_gelu_poly(x)
            dx = gelu_poly_backward(x, g)
            torch.cuda.synchronize()
            counts = port.launch_counts()
            if counts != {"gelu_poly": 1, "gelu_poly_bwd": 1}:
                fail(f"GeLUpoly {name} {shape}: launches {counts}")
            if not (torch.equal(y, fused_gelu_poly(x))
                    and torch.equal(dx, gelu_poly_backward(x, g))):
                fail(f"GeLUpoly {name} {shape}: a second launch differs")
            fwd_ulps, fwd_eq = apart(y, gelu_poly_reference(x.float()), x,
                                     None, dtype)
            bwd_ulps, bwd_eq = apart(dx, gelu_poly_backward_reference(
                x.float(), g.float()), x, g, dtype)
            bar = 1 if dtype == torch.bfloat16 else 4
            xr = x.detach().clone().requires_grad_(True)

            def plain_both():
                torch.autograd.grad(gelu_poly_reference(xr), xr, g)

            ms = time_ms(lambda: fused_gelu_poly(x), 20)
            bwd_ms = time_ms(lambda: gelu_poly_backward(x, g), 20)
            plain_ms = time_ms(lambda: gelu_poly_reference(x), 20)
            # autograd's backward of the composition: captured with its
            # forward, whose time comes off
            plain_bwd_ms = time_ms(plain_both, 20) - plain_ms
            nbytes = x.numel() * x.element_size()
            for way, k_ms, p_ms, moved, ulps, eq in (
                    ("forward", ms, plain_ms, 2 * nbytes, fwd_ulps, fwd_eq),
                    ("backward", bwd_ms, plain_bwd_ms, 3 * nbytes, bwd_ulps,
                     bwd_eq)):
                b_ms = moved / HBM_BYTES_PER_S * 1e3
                rows.append({"key": shape, "dtype": name, "way": way,
                             "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                             "bound_share": b_ms / k_ms, "ulps": ulps,
                             "bit_equal_share": eq,
                             "launches_per_train_step": 2 * calls})
                print(f"  GeLUpoly {way:8s} {name:8s} {shape}: {ulps:.2f} "
                      f"ulps apart (bar {bar}), {eq:.6f} bit-equal; kernel "
                      f"{k_ms:.4f} ms, bound (bytes) {b_ms:.4f} ms ("
                      f"{b_ms / k_ms:.3f} of it), plain {p_ms:.4f} ms; "
                      f"{2 * calls} launches a train step", flush=True)
                if not ulps <= bar:
                    fail(f"GeLUpoly {way} {name} {shape}: {ulps} ulps apart "
                         f"(bar {bar})")
            del x, g, y, dx, xr
    small = torch.randn(4096, device=dev, dtype=torch.bfloat16)
    sg = torch.ones_like(small)
    sr = small.clone().requires_grad_(True)
    host = {"fused_forward_us": host_us(lambda: fused_gelu_poly(small)),
            "plain_forward_us": host_us(lambda: gelu_poly_reference(small)),
            "fused_both_us": host_us(lambda: torch.autograd.grad(
                fused_gelu_poly(sr), sr, sg)),
            "plain_both_us": host_us(lambda: torch.autograd.grad(
                gelu_poly_reference(sr), sr, sg))}
    print(f"  GeLUpoly host us a call (4096 bf16 values, no grad forward; "
          f"forward and backward under autograd): {json.dumps(host)}",
          flush=True)
    torch.cuda.empty_cache()
    return {"rows": rows, "host_us": host}


def train_step_phase(port, torch, dev, model, label, per_step, solvers,
                     x_train, y_train, compare_attacks=False,
                     steps=TRAIN_STEPS, integration_method="backprop"):
    """The flagship recipe's train step on ``model`` (Normal(0.0125)
    smoothing, FGSM-random at 8/255 and 10/255, SGD momentum 0.9 wd 5e-4 on
    cyclic_lr(1e-7, 0.1, 3186)) in bf16: one warm-up step, then ``steps``
    counted and timed, with finite losses and exactly ``per_step`` launches
    a step.  Then the kernel path against the plain path from the initial
    weights with the draws pinned: the f32 param grads at batch 32 at the
    plain path's x_adv (1e-4 of max|g|; with ``compare_attacks`` also where
    the two paths' x_adv differ), and one bf16 step's loss (2e-2) and grad
    norm (5e-2 relative).  ``integration_method`` differentiates the ODE
    blocks (the step and the f32 gradients alike).  Returns (the counted
    steps' launches, their median ms, the peak GiB allocated)."""
    from neural_ode_metasolver_tpu_torch.attacks import (
        cross_entropy,
        fgsm_random,
    )
    from neural_ode_metasolver_tpu_torch.backend import full_f32
    from neural_ode_metasolver_tpu_torch.ops import SolverOptions
    from neural_ode_metasolver_tpu_torch.ops.noise import noise_solver
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        NoiseConfig,
        create_train_state,
        cyclic_lr,
        make_optimizer,
        make_train_step,
    )

    opt = make_optimizer("sgd", cyclic_lr(1e-7, 0.1, 3186), momentum=0.9,
                         weight_decay=5e-4)
    attack_cfg = AttackConfig(mode="fgsm_random", eps=8 / 255,
                              alpha=10 / 255, mean=CIFAR10_MEAN,
                              std=CIFAR10_STD)
    noise_cfg = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)

    def train_step(use_kernels, dtype):
        return make_train_step(model, opt, solvers, SolverOptions(),
                               attack_cfg, noise_cfg, compute_dtype=dtype,
                               use_kernels=use_kernels,
                               integration_method=integration_method)

    snapshot = {k: v.detach().clone() for k, v in model.state_dict().items()}
    state = create_train_state(model, opt)
    step = train_step(True, torch.bfloat16)
    step_gen = torch.Generator().manual_seed(10)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, x_train, y_train, step_gen)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms, loss "
          f"{metrics['loss'].item():.6f}", flush=True)
    port.reset_launch_counts()
    step_ms, losses = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = step(state, x_train, y_train, step_gen)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    counts = port.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    med = sorted(step_ms)[len(step_ms) // 2]
    print(f"  losses: {[round(l, 6) for l in losses]}", flush=True)
    print(f"  ms per step: {[round(m, 3) for m in step_ms]}", flush=True)
    print(f"  median {med:.3f} ms per step over {steps} steps (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}) = "
          f"{x_train.shape[0] / med * 1e3:.1f} img/s (bf16, batch "
          f"{x_train.shape[0]}); peak memory {peak_gb:.2f} GiB", flush=True)
    if not all(math.isfinite(l) for l in losses):
        fail(f"{label}: non-finite training loss: {losses}")
    expected = {k: v * steps for k, v in per_step.items()}
    print(f"  launch counts: {counts} (expected {per_step} per step, "
          f"{steps} steps)", flush=True)
    if counts != expected:
        fail(f"{label}: launch counts {counts} != expected {expected}")
    del state, metrics

    phase(f"{label}: kernel path vs plain path from one state, draws pinned")
    model.load_state_dict(snapshot)
    solvers_t = [noise_solver(s, torch.Generator().manual_seed(3),
                              std=0.0125, bernoulli_p=1.0,
                              noise_type="normal") for s in solvers]
    frozen = model.detached_params()
    params = [p for _, p in model.named_parameters()]
    xb, yb = x_train[:32], y_train[:32]

    def forward(use_kernels, train, tree=None):
        return lambda xi: model(xi, solvers_t, use_kernels=use_kernels,
                                train=train, params=tree,
                                integration_method=integration_method)

    def attack(use_kernels):
        return fgsm_random(forward(use_kernels, False, frozen),
                           torch.Generator(device=dev).manual_seed(4), xb,
                           yb, attack_cfg.eps, attack_cfg.alpha,
                           CIFAR10_MEAN, CIFAR10_STD)[0]

    with full_f32():
        xa_p = attack(False)
        if compare_attacks:
            xa_k = attack(True)
            # the plain path's input gradient at the pinned random start
            u = torch.rand(xb.shape, generator=torch.Generator(
                device=dev).manual_seed(4), device=dev)
            m = torch.tensor(CIFAR10_MEAN, device=dev)
            sd = torch.tensor(CIFAR10_STD, device=dev)
            eps_c = attack_cfg.eps / sd
            delta = torch.clamp(eps_c - 2.0 * eps_c * u,
                                (0.0 - m) / sd - xb,
                                (1.0 - m) / sd - xb).requires_grad_(True)
            (g_in,) = torch.autograd.grad(cross_entropy(
                forward(False, False, frozen)(xb + delta), yb), delta)
            differ = xa_k != xa_p
            n_differ = int(differ.sum())
            tiny = g_in.abs() < 1e-6 * g_in.abs().max()
            worst = (g_in.abs()[differ].max() / g_in.abs().max()).item() \
                if n_differ else 0.0
            share = n_differ / differ.numel()
            print(f"  f32 batch 32: x_adv differs at {n_differ} of "
                  f"{differ.numel()} pixels ({share:.2e}; at most 1e-3), "
                  f"largest |input grad| there {worst:.2e} of the max "
                  f"(below 1e-6), {int(tiny.sum())} pixels under 1e-6",
                  flush=True)
            if share > 1e-3 or bool((differ & ~tiny).any()):
                fail(f"{label}: kernel and plain attacks differ at "
                     f"{n_differ} pixels, gradient up to {worst:.2e} of "
                     f"the max")
            del g_in, delta, xa_k
        grads = [torch.autograd.grad(cross_entropy(
            forward(uk, True)(xa_p), yb), params) for uk in (True, False)]
    gmax = max(g.abs().max().item() for g in grads[1])
    gerr = max((a - b).abs().max().item() for a, b in zip(*grads))
    print(f"  f32 batch 32: param grads at the plain x_adv, max|diff| "
          f"{gerr:.3e} (bar 1e-4 x max|g| = {1e-4 * gmax:.3e})", flush=True)
    if not gerr <= 1e-4 * gmax:
        fail(f"{label}: kernel and plain param grads differ by {gerr}")
    del grads, xa_p

    results = {}
    for use_kernels in (True, False):
        model.load_state_dict(snapshot)
        st = create_train_state(model, opt)
        _, mt = train_step(use_kernels, torch.bfloat16)(
            st, x_train, y_train, torch.Generator().manual_seed(20))
        results[use_kernels] = (mt["loss"].item(), mt["grad_norm"].item())
    (lk, nk), (lp, np_) = results[True], results[False]
    loss_bar = 2e-2 * max(1.0, abs(lp))
    norm_rel = abs(nk - np_) / np_
    print(f"  bf16 batch {x_train.shape[0]}: loss {lk:.6f} vs plain "
          f"{lp:.6f} (|diff| {abs(lk - lp):.3e}, bar {loss_bar:.3e}); grad "
          f"norm {nk:.6f} vs {np_:.6f} (relative {norm_rel:.3e}, bar 5e-2)",
          flush=True)
    if not (abs(lk - lp) <= loss_bar and norm_rel <= 5e-2):
        fail(f"{label}: bf16 train step: kernel and plain paths disagree")
    del snapshot
    torch.cuda.empty_cache()
    return counts, med, peak_gb


def cifar_family_phases(port, torch, dev, flagship_ms):
    """Phases 18-20: the GN train step of the basic-block family, the
    model state (BN, SN) through cifar_runner, and metanode18's GN train
    step at full width.  Returns (the launches of phase 18's counted steps,
    its median ms a step, the launches of phase 19's runs, and phase 20's
    launches, ms a step and peak GiB)."""
    import tempfile

    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.runners import cifar_runner, common
    from neural_ode_metasolver_tpu_torch.training import (
        create_train_state,
        make_eval_step,
        restore_checkpoint,
    )

    solvers = parse_solver_dsl(f"rk2,u,{N_STEPS},-1,{U},-1")
    gen = torch.Generator().manual_seed(18)
    x_train = torch.randn(BATCH, 32, 32, 3, generator=gen).to(dev)
    y_train = torch.randint(0, 10, (BATCH,), generator=gen).to(dev)

    def logits_apart(model, x, what):
        """Eval logits in bf16, kernel path against plain path, within
        2^-5 of max|logit|."""
        outs = []
        for uk in (True, False):
            predict = make_eval_step(model, solvers, SolverOptions(),
                                     compute_dtype=torch.bfloat16,
                                     use_kernels=uk)
            outs.append(torch.cat([predict(xb) for xb in x]))
        err = (outs[0] - outs[1]).abs().max().item()
        bar = 2.0 ** -5 * outs[1].abs().max().item()
        print(f"  {what}: eval logits (bf16, {len(x)} x {x[0].shape[0]}) "
              f"kernel vs plain max|diff| {err:.3e} (bar {bar:.3e})",
              flush=True)
        if not (torch.isfinite(outs[0]).all() and err <= bar):
            fail(f"{what}: kernel and plain eval logits differ by {err} "
                 f"(bar {bar})")

    # ------------------------------------------------ 18 metanode10-GN
    phase(f"train: metanode10 with GroupNorm ({GN_GROUPS} groups, exact "
          f"GELU fused into B3), the flagship recipe, bf16, batch {BATCH} "
          f"(phase 9's premetanode10 NF step: {flagship_ms:.3f} ms)")
    model = build_model("metanode10", dev, generator=torch.Generator(
        ).manual_seed(0), **GN_NET)
    gn_counts, gn_med, _ = train_step_phase(
        port, torch, dev, model, "metanode10-GN", GN_TRAIN_PER_STEP, solvers,
        x_train, y_train)
    logits_apart(model, [x_train, torch.randn(
        BATCH, 32, 32, 3, generator=gen).to(dev)], "metanode10-GN")
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------- 19 model state via the CLI
    phase(f"cifar_runner: the model state (premetanode10, BN, SN, "
          f"orthogonal init), bf16, batch {BATCH}, {FAMILY_EPOCHS} epochs of "
          f"{FAMILY_STEPS} steps, then --resume; ResNet-10 with GN")
    family_counts = Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_family_") as tmp:
        save = os.path.join(tmp, "cifar")
        argv = FAMILY_ARGV + [
            "--solvers", f"rk2,u,{N_STEPS},-1,{U},-1",
            "--adv_training_mode", "fgsm_random", "--noise_type", "normal",
            "--noise_sigma", "0.0125", "--noise_prob", "1.0",
            "--precision", "bf16", "--batch_size", str(BATCH),
            "--test_batch_size", str(BATCH), "--synthetic_train_size",
            str(FAMILY_TRAIN), "--synthetic_test_size", str(BATCH),
            "--save_dir", save]
        margs = vars(cifar_runner.parse_args(argv))
        start = dict(cifar_runner.build_cifar_model(
            margs, dev, seed=margs["seed"]).named_buffers())
        want = dict(scaled(scaled(B1_TRAIN_PER_STEP, FAMILY_STEPS) + Counter(
            {"conv3x3_same": CIFAR_PASS_B1}), FAMILY_EPOCHS))
        port.reset_launch_counts()
        t0 = time.perf_counter()
        ts = cifar_runner.main(argv + ["--nepochs", str(FAMILY_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = port.launch_counts()
        family_counts += Counter(got)
        ep = [r for r in read_metrics(save) if "train_loss" in r]
        print(f"  {wall:.3f} s; train losses "
              f"{[round(r['train_loss'], 6) for r in ep]}, batch_time "
              f"{[round(r['batch_time'] * 1e3, 3) for r in ep]} ms; "
              f"launches {got} (expected {want})", flush=True)
        if len(ep) != FAMILY_EPOCHS or not all(
                math.isfinite(r["train_loss"]) for r in ep):
            fail(f"cifar_runner BN+SN: epoch records {ep}")
        if got != want:
            fail(f"cifar_runner BN+SN: launches {got} != expected {want}")
        trained = {k: v.clone() for k, v in ts.model_state.items()}
        kinds = Counter(k.rsplit(".", 1)[-1] for k in trained)
        # BN inside the ODE RHS would keep its statistics; this net has none
        moved = [k for k in trained if not torch.equal(trained[k], start[k])]
        print(f"  model state: {len(trained)} buffers ({dict(kinds)}), "
              f"{len(moved)} moved off the init", flush=True)
        if not trained or len(moved) != len(trained) or not all(
                torch.isfinite(v).all() for v in trained.values()):
            fail(f"cifar_runner BN+SN: model state moved at {len(moved)} of "
                 f"{len(trained)} buffers")
        # --resume with no epoch to run hands back what it restored
        resumed = cifar_runner.main(argv + ["--resume", "--nepochs", "0"])
        same = all(torch.equal(resumed.model_state[k], v)
                   for k, v in trained.items())
        print(f"  --resume: step {resumed.step}, model state bit for bit "
              f"{same}", flush=True)
        if resumed.step != ts.step or not same:
            fail("cifar_runner --resume: the model state is not restored "
                 "bit for bit")
        again = cifar_runner.main(argv + ["--resume", "--nepochs", "1"])
        print(f"  --resume --nepochs 1: step {again.step}", flush=True)
        if again.step != ts.step + FAMILY_STEPS:
            fail(f"cifar_runner --resume: step {again.step}")
        cmodel = cifar_runner.build_cifar_model(margs, dev)
        restore_checkpoint(os.path.join(save, "last"), create_train_state(
            cmodel, common.optimizer_from_saved_args(margs)), ts.step)
        gen.manual_seed(19)
        port.reset_launch_counts()
        logits_apart(cmodel, [torch.randn(BATCH, 32, 32, 3, generator=gen)
                              .to(dev)], "premetanode10 BN+SN (restored)")
        family_counts += Counter(port.launch_counts())
        del cmodel

    resnet = build_model("metanode10", dev, is_odenet=False,
                         generator=torch.Generator().manual_seed(0), **GN_NET)
    xr = [torch.randn(BATCH, 32, 32, 3, generator=gen).to(dev)]
    port.reset_launch_counts()
    with torch.inference_mode():
        resnet(xr[0].to(torch.bfloat16), None)
    torch.cuda.synchronize()
    got = port.launch_counts()
    print(f"  ResNet-10 GN clean batch: launches {got} (expected "
          f"{RESNET10_PER_BATCH})", flush=True)
    if got != RESNET10_PER_BATCH:
        fail(f"ResNet-10 GN launches {got} != {RESNET10_PER_BATCH}")
    port.reset_launch_counts()
    logits_apart(resnet, xr, "ResNet-10 GN")
    family_counts += Counter(port.launch_counts()) + Counter(got)
    del resnet
    torch.cuda.empty_cache()

    # ---------------------------------------- 20 metanode18-GN, full width
    phase(f"train: metanode18 with GroupNorm ({GN_GROUPS} groups, exact "
          f"GELU; 256 channels at 8x8 and 512 at 4x4), the flagship recipe, "
          f"bf16, batch {BATCH}: one warm-up and {M18_TRAIN_STEPS} counted "
          f"step, kernel path against plain path")
    model = build_model("metanode18", dev, generator=torch.Generator(
        ).manual_seed(0), **GN_NET)
    m18 = train_step_phase(port, torch, dev, model, "metanode18-GN",
                           M18_TRAIN_PER_STEP, solvers, x_train, y_train,
                           steps=M18_TRAIN_STEPS)
    del model
    torch.cuda.empty_cache()
    return gn_counts, gn_med, family_counts, m18


def a18_phases(port, torch, dev, flagship_ms, flagship_peak, mnist_ms):
    """Phases 21-22: the flagship step under the continuous adjoint, and
    trainable solver coefficients through mnist_runner.  Returns (phase
    21's counted launches, median ms a step, peak GiB; phase 22's
    launches in the runner, launches of one solver step, the runner's
    steady ms a step, peak GiB)."""
    import tempfile

    from neural_ode_metasolver_tpu_torch.attacks import cross_entropy
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.runners import common, mnist_runner
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        create_solver_train_state,
        make_optimizer,
        make_solver_train_step,
        restore_checkpoint,
        solvers_from_state,
    )

    solvers = parse_solver_dsl(f"rk2,u,{N_STEPS},-1,{U},-1")
    # ------------------------------------------------ 21 adjoint, flagship
    phase(f"train: the flagship step under the continuous adjoint "
          f"(premetanode10, in_planes 64, GeLUpoly), bf16, batch {BATCH} "
          f"(phase 9's backprop step: {flagship_ms:.3f} ms, peak "
          f"{flagship_peak:.2f} GiB)")
    model = build_model("premetanode10", in_planes=64,
                        acts=("GeLUpoly",) * 3,
                        generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)  # phase 9's images and labels
    x_train = torch.randn(BATCH, 32, 32, 3, generator=gen).to(dev)
    y_train = torch.randint(0, 10, (BATCH,), generator=gen).to(dev)
    adj_counts, adj_ms, adj_peak = train_step_phase(
        port, torch, dev, model, "train (adjoint)", ADJ_TRAIN_PER_STEP,
        solvers, x_train, y_train, integration_method="adjoint")
    print(f"  adjoint step {adj_ms:.3f} ms against backprop's "
          f"{flagship_ms:.3f} ms ({adj_ms / flagship_ms:.3f}x); peak memory "
          f"{adj_peak:.2f} GiB against backprop's {flagship_peak:.2f} GiB",
          flush=True)
    if not adj_peak < flagship_peak:
        fail(f"the adjoint step's peak memory {adj_peak:.2f} GiB is not "
             f"below backprop's {flagship_peak:.2f} GiB")
    del model, x_train, y_train
    torch.cuda.empty_cache()

    # ------------------------------------ 22 trainable u via mnist_runner
    phase(f"mnist_runner --train_solver_params --lr_uv {SOLVER_LR_UV}: the "
          f"digits recipe (dim {MNIST_DIM}, PGD-{PGD_ITERS}, RMSprop), f32, "
          f"batch {MNIST_TRAIN_BATCH}, {SOLVER_EPOCHS} epochs of "
          f"{RUNNER_MNIST_STEPS} steps")
    per_epoch = (scaled(MNIST_TRAIN_PER_STEP, RUNNER_MNIST_STEPS)
                 + Counter(EVAL_CLEAN_PER_BATCH))
    want = dict(scaled(per_epoch, SOLVER_EPOCHS))
    with tempfile.TemporaryDirectory(prefix="chip_smoke_solver_") as tmp:
        save = os.path.join(tmp, "solver")
        torch.cuda.reset_peak_memory_stats()
        port.reset_launch_counts()
        t0 = time.perf_counter()
        ts = mnist_runner.main(digits_runner_argv(save) + [
            "--train_solver_params", "--lr_uv", str(SOLVER_LR_UV),
            "--nepochs", str(SOLVER_EPOCHS)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        solver_counts = port.launch_counts()
        solver_peak = torch.cuda.max_memory_allocated() / 2 ** 30
        recs = [r for r in read_metrics(save) if "train_loss" in r]
        for r in recs:
            print(f"  epoch {int(r['epoch'])}: train loss "
                  f"{r['train_loss']:.6f}, accuracy {r['accuracy']:.4f}, u "
                  f"{r['solver0_u']:.7f}, batch_time "
                  f"{r['batch_time'] * 1e3:.3f} ms = "
                  f"{MNIST_TRAIN_BATCH / r['batch_time']:.1f} img/s (phase "
                  f"11's bare frozen-u step: {mnist_ms:.3f} ms)", flush=True)
        solver_ms = recs[-1]["batch_time"] * 1e3 if recs else float("nan")
        print(f"  {wall:.3f} s for {SOLVER_EPOCHS} epochs; peak memory "
              f"{solver_peak:.2f} GiB; launches {solver_counts} (expected "
              f"{want}: per epoch {RUNNER_MNIST_STEPS} x phase 11's step and "
              f"one clean validation batch)", flush=True)
        us = [r["solver0_u"] for r in recs]
        if len(recs) != SOLVER_EPOCHS or not all(
                math.isfinite(r["train_loss"]) for r in recs):
            fail(f"mnist_runner --train_solver_params: records {recs}")
        if not all(1e-3 <= u <= 1.0 for u in us) or us[-1] == U:
            fail(f"mnist_runner --train_solver_params: u {us} did not move "
                 f"off {U} or left [1e-3, 1]")
        if solver_counts != want:
            fail(f"mnist_runner --train_solver_params: launches "
                 f"{solver_counts} != expected {want}")
        # solver_trained restores bit for bit: params, u, both optimizers
        base = os.path.join(save, "solver_trained")
        check_checkpoint_dir(base)
        with open(os.path.join(base, check_checkpoint_dir(base)[-1],
                               "config.json")) as f:
            cfg = json.load(f)
        fresh_model = build_model("mnist", dim=MNIST_DIM)
        fresh = create_solver_train_state(
            fresh_model, common.optimizer_from_saved_args(cfg["args"]),
            make_optimizer("sgd", SOLVER_LR_UV), solvers)
        got, _ = restore_checkpoint(base, fresh)

        def same_opt(a, b):
            return a.keys() == b.keys() and all(
                (v.keys() == a[k].keys() and all(torch.equal(a[k][n], t)
                                                 for n, t in v.items()))
                if isinstance(v, dict) else a[k] == v for k, v in b.items())

        same = (got.step == ts.step
                and all(torch.equal(got.params[k], v)
                        for k, v in ts.params.items())
                and torch.equal(got.solver_params[0]["u"],
                                ts.solver_params[0]["u"])
                and same_opt(got.opt_state, ts.opt_state)
                and same_opt(got.solver_opt_state, ts.solver_opt_state))
        print(f"  solver_trained at step {got.step}: params, u "
              f"{got.solver_params[0]['u'].item():.7f} and both optimizer "
              f"states restore bit for bit: {same}", flush=True)
        if not same:
            fail("solver_trained does not restore bit for bit")
        del ts, got, fresh, fresh_model

    # kernel path against plain path from one state
    mnist = build_model("mnist", dim=MNIST_DIM,
                        generator=torch.Generator().manual_seed(0))
    snap = {k: p.detach().clone() for k, p in mnist.named_parameters()}
    gen = torch.Generator().manual_seed(2)  # phase 11's images and labels
    xm = torch.rand(MNIST_TRAIN_BATCH, 28, 28, 1, generator=gen).to(dev)
    ym = torch.randint(0, 10, (MNIST_TRAIN_BATCH,), generator=gen).to(dev)
    atk = AttackConfig(mode="at", eps=PGD_EPS, pgd_lr=PGD_LR,
                       pgd_niter=PGD_ITERS)
    results = {}
    for use_kernels in (True, False):
        mnist.load_state_dict(snap)
        opt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
        sopt = make_optimizer("sgd", SOLVER_LR_UV)
        st = create_solver_train_state(mnist, opt, sopt, solvers)
        step = make_solver_train_step(mnist, opt, sopt, solvers,
                                      SolverOptions(), atk,
                                      use_kernels=use_kernels)
        port.reset_launch_counts()
        _, mt = step(st, xm, ym, torch.Generator().manual_seed(22))
        torch.cuda.synchronize()
        results[use_kernels] = (mt["loss"].item(),
                                mt["solver_grad_norm"].item(),
                                port.launch_counts())
    (lk, sk, step_counts), (lp, sp, plain_counts) = (results[True],
                                                     results[False])
    print(f"  one solver step, f32 batch {MNIST_TRAIN_BATCH}: loss {lk:.6f} "
          f"vs plain {lp:.6f} (bar 2e-2); |du| {sk:.6e} vs {sp:.6e} (bar "
          f"5e-2 relative: PGD's sign steps carry rounding on); launches "
          f"{step_counts} (expected {MNIST_TRAIN_PER_STEP}; plain path "
          f"{plain_counts})", flush=True)
    if not abs(lk - lp) <= 2e-2 * max(1.0, abs(lp)):
        fail("solver train step: kernel and plain losses disagree")
    if not abs(sk - sp) <= 5e-2 * sp:
        fail(f"solver train step: solver_grad_norm {sk} against the plain "
             f"path's {sp}")
    if step_counts != MNIST_TRAIN_PER_STEP or plain_counts:
        fail(f"solver train step: launches {step_counts} != expected "
             f"{MNIST_TRAIN_PER_STEP}, or the plain path launched "
             f"{plain_counts}")
    mnist.load_state_dict(snap)
    params = list(mnist.parameters())
    grads = []
    for use_kernels in (True, False):
        u = torch.tensor(U, device=dev, requires_grad=True)
        with torch.enable_grad():
            loss = cross_entropy(mnist(
                xm, solvers_from_state(solvers, [{"u": u, "v": None}]),
                use_kernels=use_kernels, train=True), ym)
            grads.append(torch.autograd.grad(loss, params + [u]))
    gmax = max(g.abs().max().item() for g in grads[1][:-1])
    gerr = max((a - b).abs().max().item()
               for a, b in zip(grads[0][:-1], grads[1][:-1]))
    # du is a sum that cancels, so f32 rounding alone moves it by some 1e-3
    # of itself: both paths' du in f32 are held against the plain path's in
    # f64, at a bar above that floor
    mnist.double()
    u64 = torch.tensor(U, device=dev, dtype=torch.float64,
                       requires_grad=True)
    solvers64 = [s.replace(u=s.u.double()) for s in solvers]
    with torch.enable_grad():
        (du64,) = torch.autograd.grad(cross_entropy(mnist(
            xm.double(), solvers_from_state(solvers64,
                                            [{"u": u64, "v": None}]),
            use_kernels=False, train=True), ym), u64)
    du_k, du_p, du64 = grads[0][-1].item(), grads[1][-1].item(), du64.item()
    rel_k, rel_p = (abs(d - du64) / abs(du64) for d in (du_k, du_p))
    print(f"  f32 batch {MNIST_TRAIN_BATCH} at the clean images: du "
          f"{du_k:.6e} kernel path, {du_p:.6e} plain path (apart "
          f"{abs(du_k - du_p) / abs(du_p):.3e} relative), against the "
          f"plain path in f64 {du64:.6e}: kernel {rel_k:.3e}, plain "
          f"{rel_p:.3e} (bar {SOLVER_DU_BAR:g} relative); param grads "
          f"max|diff| {gerr:.3e} (bar 1e-3 x max|g| = {1e-3 * gmax:.3e})",
          flush=True)
    if not (rel_k <= SOLVER_DU_BAR and rel_p <= SOLVER_DU_BAR
            and gerr <= 1e-3 * gmax):
        fail(f"solver train: gradients off (u: kernel {rel_k}, plain "
             f"{rel_p} from f64; params {gerr})")
    del mnist, grads
    torch.cuda.empty_cache()
    return (adj_counts, adj_ms, adj_peak, solver_counts, step_counts,
            solver_ms, solver_peak)


# Phases 23-25: the fleet (training/fleet.py), S runs in one step.  The
# u-sweep recipe (runners/u_sweep.py, configs/mnist_u_sweep.sh): the MNIST
# MetaNODE at dim 64, batch 128 a member, f32, RK2 over 8 steps, RMSprop
# 1e-3 with weight decay 5e-4, clean training; 4 values of u x 4 seeds.
FLEET_US = (0.25, 0.5, 0.75, 1.0)
FLEET_SEEDS = (1, 2, 3, 4)
FLEET_S = len(FLEET_US) * len(FLEET_SEEDS)  # 16
FLEET_N = MNIST_TRAIN_BATCH
FLEET_LR = 1e-3
# members of the fleets whose step time and peak memory phase 24 measures
# (runners/u_sweep.py::FLEET_SAFE_CHUNK is set from them)
FLEET_SIZES = (1, 4, 8, 16, 32)
# the MNIST step's GroupNorms (H, W, C) at dim 64 and their activations
FLEET_GN_SHAPES = ((26, 26, MNIST_DIM), (13, 13, MNIST_DIM),
                   (6, 6, MNIST_DIM))
# fleet against each member's single run, two steps from one state: the
# first step's losses within JAX's fleet bar (tests/test_fleet.py, 2e-5
# relative) and grad norms within 1e-4; after the second step (RMSprop
# turns a gradient element at rounding level into a +-10 lr move, so
# rounding alone moves some elements far: the f64 witness shows how many)
# the losses within 1e-3 relative and at most 1e-2 of the param elements
# more than 1e-4 x max|p| apart
FLEET_LOSS1_BAR, FLEET_GNORM1_BAR = 2e-5, 1e-4
FLEET_LOSS2_BAR, FLEET_FAR_SHARE_BAR = 1e-3, 1e-2
# phase 25: u_sweep at full width on synthetic data, sequential and
# --fleet.  The issue-size runs (RUNNER_MNIST_TRAIN images, 1 epoch of 10
# steps) are timed and their CSVs checked; their clean accuracies are
# printed, not held: by the tenth RMSprop step from a random init the
# members' accuracies turn on rounding (the sequential sweep alone, the same
# inputs in two runs on an H100 80GB HBM3, read 0.0879 and 0.1660 for one
# member: cuDNN's backward-weight sums are ordered by atomics, and RMSprop
# turns a rounding-level gradient into a +-10 lr move).  The per-member
# comparison is held on runs of USWEEP_HELD_TRAIN images (two steps a
# member), sequential against --fleet --fleet_chunk USWEEP_HELD_CHUNK
# (three fleets, the last padded): two steps from one init keep each member
# within rounding of its single run (phase 24), so each member's clean and
# PGD counts agree within USWEEP_HELD_BAR image of the test set (they read
# equal on the card), while members of another seed or u read 1 to 7
# images apart
USWEEP_U, USWEEP_SEEDS = "0.25,0.5,0.75,1.0", "1,2"
USWEEP_HELD_TRAIN, USWEEP_HELD_CHUNK, USWEEP_HELD_BAR = 2 * FLEET_N, 3, 1


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN on its deterministic algorithms inside the block.  Its default
    algorithms for the stem and strided convs may order their sums by
    atomics, and two steps of RMSprop turn a rounding-level gradient into a
    +-10 lr move: run to run, phase 24's member-against-single share of
    params apart read 1.06e-3 to 1.06e-2 on an H100 80GB HBM3 (the same
    program, the same inputs); on the deterministic algorithms it reads
    one value.  The timed steps keep cuDNN's defaults."""
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = saved


def params_apart(pa, pb):
    """Two runs' params by name: the share of elements more than 1e-4 of
    max|pb| apart, and the largest difference over max|pb|."""
    big = max(v.detach().abs().max().item() for v in pb.values())
    diffs = [(pa[k].detach().double() - pb[k].detach().double()).abs()
             for k in pb]
    far = sum((d > 1e-4 * big).sum().item() for d in diffs)
    return (far / sum(d.numel() for d in diffs),
            max(d.max().item() for d in diffs) / big)


def member_launch_phase(port, torch, dev, time_ms, bound, randn):
    """Phase 23: each member-batched launch of the u-sweep's step at S =
    FLEET_S, N = FLEET_N against S single launches (bit-equal) and against
    its plain version (phases 4 and 6b's bars), with device ms of the
    member-batched launch, of S single launches, of the library call and
    the bound.  Returns the rows."""
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_dgrad, conv3x3_f32_plan, conv3x3_path, conv3x3_same,
        conv3x3_wgrad, flip_weights, reference_conv3x3,
        reference_conv3x3_wgrad, wgrad_plan)
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act, group_norm_backward,
        group_norm_backward_reference, group_norm_reference, launch_plan)

    F = torch.nn.functional
    aten = torch.ops.aten
    s, n = FLEET_S, FLEET_N
    f32 = torch.float32
    phase(f"the member-batched launches: {s} members of {n} images at the "
          f"MNIST u-sweep's shapes (f32), against {s} single launches and "
          f"the plain versions")
    rows = []

    def record(name, key, plan, batched, single, plain, library, bar,
               nbytes, flops, ms_reps=10, compare=None):
        """``compare``: what the outputs are held against (default the
        plain version's)."""
        got = batched()
        singles = [single(m) for m in range(s)]
        torch.cuda.synchronize()
        outs = got if isinstance(got, tuple) else (got,)
        for i, o in enumerate(outs):
            want = torch.stack([sg[i] if isinstance(sg, tuple) else sg
                                for sg in singles])
            if not torch.equal(o, want):
                fail(f"{name} {key}: the member-batched launch is not "
                     f"bit-equal to {s} single launches (output {i}, "
                     f"max|diff| {(o - want).abs().max().item():.3e})")
        ref = (compare or plain)()
        refs = ref if isinstance(ref, tuple) else (ref,)
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(outs, refs)]
        bars = bar if isinstance(bar, (list, tuple)) else [bar]
        ms = time_ms(batched, ms_reps)
        singles_ms = time_ms(lambda: [single(m) for m in range(s)], 2)
        plain_ms = time_ms(plain, 2)
        lib_ms = time_ms(library, ms_reps)
        b_ms, b_bytes, b_ops = bound(nbytes, flops, f32)
        row = {"kernel": name, "key": key, "plan": plan, "members": s,
               "dtype": "float32", "bit_equal": True,
               "max_abs_err": max(errs), "ms": ms,
               "singles_ms": singles_ms, "plain_ms": plain_ms,
               "library_ms": lib_ms, "bound_ms": b_ms, "bytes_ms": b_bytes,
               "ops_ms": b_ops,
               "bound_by": "operations" if b_ops >= b_bytes else "bytes"}
        rows.append(row)
        print(f"  {name} {key}: {plan}; bit-equal to {s} single launches; "
              f"max|diff| vs plain {[f'{e:.3e}' for e in errs]} (bars "
              f"{[f'{b:.3e}' for b in bars]}); one launch {ms:.4f} ms, "
              f"{s} single launches {singles_ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms ({row['bound_by']}, {b_ms / ms:.3f} of it)",
              flush=True)
        if not all(e <= b for e, b in zip(errs, bars)):
            fail(f"{name} {key}: max|diff| {errs} > {bars}")

    # B1 at the ConcatConv2d (N, 6, 6, 65 -> 64), its dgrad (64 -> 65) and
    # the split-K wgrad
    _, h, w, cin, cout = TRAIN_MNIST
    x = randn((s, n, h, w, cin), 1.0, 31, f32)
    k = randn((s, 3, 3, cin, cout), (9 * cin) ** -0.5, 32, f32)
    dy = randn((s, n, h, w, cout), 1.0, 33, f32)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def grouped(t):  # (S, N, H, W, C) -> (N, S*C, H, W), contiguous
        return t.permute(1, 0, 4, 2, 3).reshape(n, -1, h, w).contiguous()

    xg, dyg = grouped(x), grouped(dy)
    kg = k.permute(0, 4, 3, 1, 2).reshape(s * cout, cin, 3, 3).contiguous()
    flops = 2 * s * n * h * w * cin * cout * 9
    # each member runs a single run's plan, which the launcher takes
    fwd_plan = conv3x3_f32_plan(n, h, w, cin, cout, sms)
    dgrad_plan = conv3x3_f32_plan(n, h, w, cout, cin, sms)
    fwd_path = conv3x3_path(n, h, w, cin, cout, f32, dev)
    dgrad_path = conv3x3_path(n, h, w, cout, cin, f32, dev)
    plan = wgrad_plan(n, h, w, cin, cout, f32, sms)
    if plan.path != "f32":
        fail(f"the member-batched wgrad's plan {plan} is not the f32 plan")
    if (fwd_path, dgrad_path) != (fwd_plan.path, dgrad_plan.path):
        fail(f"B1 at the ConcatConv2d took {fwd_path} / {dgrad_path}, not "
             f"its f32 plans' {fwd_plan.path} / {dgrad_plan.path}")
    with torch.no_grad():
        y_ref = reference_conv3x3(x, k)
        record("conv3x3_same", (n, h, w, cin, cout),
               f"plan {tuple(fwd_plan)}",
               lambda: conv3x3_same(x, k),
               lambda m: conv3x3_same(x[m], k[m]),
               lambda: reference_conv3x3(x, k),
               lambda: F.conv2d(xg, kg, padding=1, groups=s),
               1e-4 * max(1.0, y_ref.abs().max().item()),
               (x.numel() + k.numel() + dy.numel()) * 4, flops)
        dx_ref = reference_conv3x3(dy, flip_weights(k))
        record("conv3x3_dgrad", (n, h, w, cout, cin),
               f"plan {tuple(dgrad_plan)}",
               lambda: conv3x3_dgrad(dy, k),
               lambda m: conv3x3_dgrad(dy[m], k[m]),
               lambda: reference_conv3x3(dy, flip_weights(k)),
               lambda: torch.nn.grad.conv2d_input(
                   (n, s * cin, h, w), kg, dyg, padding=1, groups=s),
               1e-4 * max(1.0, dx_ref.abs().max().item()),
               (dy.numel() + k.numel() + x.numel()) * 4, flops)
        dw_ref = reference_conv3x3_wgrad(x, dy)
        record("conv3x3_wgrad", (n, h, w, cin, cout),
               f"plan {plan.path}, {plan.splits} K ranges a member, "
               f"{plan.stages} ring slots",
               lambda: conv3x3_wgrad(x, dy),
               lambda m: conv3x3_wgrad(x[m], dy[m]),
               lambda: reference_conv3x3_wgrad(x, dy),
               lambda: torch.nn.grad.conv2d_weight(
                   xg, (s * cout, cin, 3, 3), dyg, padding=1, groups=s),
               1e-5 * max(1.0, dw_ref.abs().max().item()),
               (x.numel() + dy.numel() + k.numel()) * 4, flops)
    del x, k, dy, xg, dyg, kg, dx_ref, dw_ref, y_ref
    torch.cuda.empty_cache()

    # B3 forward and backward at the MNIST GroupNorms, relu and none
    for h, w, c in FLEET_GN_SHAPES:
        for act in ("relu", None):
            fplan = launch_plan(n, h, w, c, GN_GROUPS, f32)
            bplan = launch_plan(n, h, w, c, GN_GROUPS, f32, backward=True)
            if (fplan, bplan) != (
                    launch_plan(s * n, h, w, c, GN_GROUPS, f32),
                    launch_plan(s * n, h, w, c, GN_GROUPS, f32,
                                backward=True)):
                fail(f"B3 plans at {(h, w, c)} depend on the member count")
            x = randn((s, n, h, w, c), 2.0, 34, f32) + 0.5
            sc = randn((s, c), 0.3, 35, f32) + 1.0
            bi = randn((s, c), 0.5, 36, f32)
            g = randn((s, n, h, w, c), 1.0, 37, f32)
            lib_act = {None: lambda t: t, "relu": torch.relu}[act]
            x_cl = x.reshape(s * n, h, w, c).permute(0, 3, 1, 2)
            sc5, bi5 = sc.reshape(s, 1, c, 1, 1), bi.reshape(s, 1, c, 1, 1)

            def gn_library():
                y = F.group_norm(x_cl, GN_GROUPS, eps=1e-5)
                return lib_act(y.view(s, n, c, h, w) * sc5 + bi5)

            ref = group_norm_reference(x, sc, bi, GN_GROUPS, act=act)
            key = (n, h, w, c, act)
            record("group_norm_act", key,
                   f"plan {fplan.path}, cluster {fplan.cluster}",
                   lambda: fused_group_norm_act(x, sc, bi, GN_GROUPS,
                                                act=act),
                   lambda m: fused_group_norm_act(x[m], sc[m], bi[m],
                                                  GN_GROUPS, act=act),
                   lambda: group_norm_reference(x, sc, bi, GN_GROUPS,
                                                act=act),
                   gn_library, 2e-4 * max(1.0, ref.abs().max().item()),
                   2 * x.numel() * 4 + 2 * s * c * 4,
                   GN_OPS_PER_ELEMENT * x.numel())
            # backward: dx only (the attack's) and full (the training
            # pass's); the library composes aten's GN backward without
            # affine on S*N samples with the members' affine and relu mask
            xc = x_cl.contiguous()
            gc = g.reshape(s * n, h, w, c).permute(0, 3, 1, 2).contiguous()
            xhat, mean_l, rstd_l = aten.native_group_norm(
                xc, None, None, s * n, c, h * w, GN_GROUPS, 1e-5)
            y_aff = (xhat.view(s, n, c, h, w) * sc5 + bi5).view_as(xc)

            def bwd_library(full):
                gy = (aten.threshold_backward(gc, y_aff, 0.0)
                      if act == "relu" else gc)
                gx = (gy.view(s, n, c, h, w) * sc5).view_as(xc)
                dx = aten.native_group_norm_backward(
                    gx, xc, mean_l, rstd_l, None, s * n, c, h * w,
                    GN_GROUPS, [True, False, False])[0]
                if not full:
                    return dx
                g5 = gy.view(s, n, c, h * w)
                return (dx, (g5 * xhat.view(s, n, c, h * w)).sum((1, 3)),
                        g5.sum((1, 3)))

            # ReLU's mask at a pre-activation within rounding of 0 may
            # differ between B3 and its plain version (their forwards are
            # 2e-6 apart here), and a flip moves its group's dx by up to
            # |dout| x rstd x scale.  So the plain backward held against
            # the kernel's takes the mask of the kernel's own forward
            # output: dpre = dout x [y > 0], then the backward without an
            # activation, the same function at every element
            with torch.no_grad():
                mask = (None if act is None else
                        fused_group_norm_act(x, sc, bi, GN_GROUPS,
                                             act=act) > 0)

            def bwd_compare():
                if mask is None:
                    return group_norm_backward_reference(x, sc, bi, g,
                                                         GN_GROUPS)
                return group_norm_backward_reference(x, sc, bi, g * mask,
                                                     GN_GROUPS)

            bref = bwd_compare()
            xf = x.reshape(s, n, h * w, GN_GROUPS, c // GN_GROUPS)
            xh = ((xf - xf.mean((2, 4), keepdim=True)) * torch.rsqrt(
                xf.var((2, 4), unbiased=False, keepdim=True) + 1e-5))
            l1 = 2.0 * g.abs().reshape(xh.shape)
            bars = [1e-4 * max(1.0, bref[0].abs().max().item()),
                    1e-5 * max(1.0, (l1 * xh.abs()).sum((1, 2, 3, 4))
                               .max().item()),
                    1e-5 * max(1.0, l1.sum((1, 2, 3, 4)).max().item())]
            del xf, xh, l1
            for full in (False, True):
                record("group_norm_act_bwd", key + ("full" if full
                                                    else "dx",),
                       f"plan {bplan.path}, cluster {bplan.cluster}",
                       (lambda f=full: group_norm_backward(
                           x, sc, bi, g, GN_GROUPS, act=act, params=f)[
                           :3 if f else 1]),
                       (lambda m, f=full: group_norm_backward(
                           x[m], sc[m], bi[m], g[m], GN_GROUPS, act=act,
                           params=f)[:3 if f else 1]),
                       (lambda f=full: group_norm_backward_reference(
                           x, sc, bi, g, GN_GROUPS, act=act)[:3 if f
                                                             else 1]),
                       (lambda f=full: bwd_library(f)),
                       bars if full else bars[:1],
                       3 * x.numel() * 4 + (2 * s * c * 4 if full else 0),
                       GN_BWD_OPS_PER_ELEMENT * x.numel(),
                       compare=(lambda f=full: bwd_compare()[:3 if f
                                                             else 1]))
            del x, g, ref, bref, xc, gc, xhat, y_aff, mask
    torch.cuda.empty_cache()
    return rows


def fleet_train_phases(port, torch, dev):
    """Phase 24: the u-sweep step as one fleet of FLEET_S members against
    its single-run step (launches, ms, img/s, peak memory, at FLEET_SIZES
    members too), each member against its own single run, the kernel path
    against the plain path, and one step under PGD-7.  Returns the report's
    numbers."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import SolverOptions, create_solver
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, create_fleet_state, create_train_state,
        fleet_generators, make_fleet_train_step, make_optimizer,
        make_train_step, stack_fleet_solvers)

    s, n = FLEET_S, FLEET_N
    opts = SolverOptions()
    phase(f"train: the u-sweep recipe as one fleet of {s} members "
          f"({len(FLEET_US)} u x {len(FLEET_SEEDS)} seeds; MNIST MetaNODE "
          f"dim {MNIST_DIM}, f32, batch {n} a member, RK2 {N_STEPS} steps, "
          f"RMSprop {FLEET_LR}, clean)")
    ref_solver = create_solver("rk2", "u", n_steps=N_STEPS, u0=U)
    members = [(u, seed) for u in FLEET_US for seed in FLEET_SEEDS]
    u_solver = lambda u: [ref_solver.replace(  # noqa: E731
        u=torch.tensor(u, dtype=torch.float32))]
    opt = make_optimizer("rmsprop", FLEET_LR, weight_decay=5e-4)
    model = build_model("mnist", dim=MNIST_DIM)
    gcpu = torch.Generator().manual_seed(23)
    xs = torch.rand(2 * s, n, 28, 28, 1, generator=gcpu).to(dev)
    ys = torch.randint(0, 10, (2 * s, n), generator=gcpu).to(dev)

    def fleet_of(count, use_kernels=True, attack=AttackConfig()):
        part = [members[i % s] for i in range(count)]
        gens = fleet_generators([seed for _, seed in part])
        fts = create_fleet_state(model, opt, gens)
        dyn = stack_fleet_solvers([u_solver(u) for u, _ in part])
        step = make_fleet_train_step(model, opt, [ref_solver], opts,
                                     attack, use_kernels=use_kernels)
        return fts, gens, dyn, step

    def timed(fn, steps):
        fn()  # warm-up
        torch.cuda.synchronize()
        port.reset_launch_counts()
        ms = []
        for _ in range(steps):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return sorted(ms)[len(ms) // 2], port.launch_counts(), out

    # the single run: member 0's step
    u0, seed0 = members[0]
    single = build_model("mnist", dim=MNIST_DIM,
                         generator=torch.Generator().manual_seed(seed0))
    sstate = create_train_state(single, opt)
    sstep = make_train_step(single, opt, [ref_solver], opts)
    sgen = torch.Generator().manual_seed(seed0)
    single_ms, scounts, _ = timed(lambda: sstep(
        sstate, xs[0], ys[0], sgen, u_solver(u0)), TRAIN_STEPS)
    single_per_step = {k: v // TRAIN_STEPS for k, v in scounts.items()}
    print(f"  single run: median {single_ms:.3f} ms a step; launches a "
          f"step {single_per_step}", flush=True)
    del single, sstate

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fts, gens, dyn, fstep = fleet_of(s)
    box = {}

    def one_fleet_step():
        box["state"], box["m"] = fstep(fts, xs[:s], ys[:s], gens, dyn)
        return box["m"]

    fleet_ms, fcounts, _ = timed(one_fleet_step, TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    fleet_per_step = {k: v // TRAIN_STEPS for k, v in fcounts.items()}
    losses = box["m"]["loss"]
    print(f"  fleet of {s}: median {fleet_ms:.3f} ms a step against "
          f"{s} x {single_ms:.3f} = {s * single_ms:.3f} ms for {s} single "
          f"steps ({s * single_ms / fleet_ms:.2f}x); "
          f"{s * n / fleet_ms * 1e3:.1f} img/s over all members "
          f"({n / single_ms * 1e3:.1f} single); peak {peak:.2f} GiB",
          flush=True)
    print(f"  launches a fleet step {fleet_per_step} (a single step "
          f"{single_per_step}); last losses "
          f"{[round(v, 5) for v in losses.tolist()]}", flush=True)
    if not torch.isfinite(losses).all():
        fail(f"non-finite fleet losses {losses.tolist()}")
    if fleet_per_step != single_per_step or set(fleet_per_step) != {
            "conv3x3_same", "conv3x3_dgrad", "conv3x3_wgrad",
            "group_norm_act", "group_norm_act_bwd",
            "group_norm_act_bwd_params"}:
        fail(f"a fleet step launches {fleet_per_step}, a single step "
             f"{single_per_step}")
    del fts, box["state"]
    torch.cuda.empty_cache()

    # the chunk measurement: step time and peak memory by fleet size
    sizes = []
    for count in FLEET_SIZES:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fts_c, gens_c, dyn_c, step_c = fleet_of(count)
        xc, yc = xs[:count], ys[:count]
        ms_c, _, _ = timed(lambda: step_c(fts_c, xc, yc, gens_c, dyn_c), 2)
        peak_c = torch.cuda.max_memory_allocated() / 2 ** 30
        sizes.append({"members": count, "step_ms": ms_c,
                      "img_s": count * n / ms_c * 1e3,
                      "img_s_per_member": n / ms_c * 1e3,
                      "peak_gib": peak_c})
        print(f"  chunk {count:2d} members: {ms_c:.3f} ms a step, "
              f"{count * n / ms_c * 1e3:.1f} img/s "
              f"({n / ms_c * 1e3:.1f} a member), peak {peak_c:.2f} GiB",
              flush=True)
        del fts_c
    torch.cuda.empty_cache()

    # each member against its own single run: two steps from one state,
    # cuDNN deterministic on both sides
    with deterministic_cudnn(torch):
        fts, gens, dyn, fstep = fleet_of(s)
        f1, m1 = fstep(fts, xs[:s], ys[:s], gens, dyn)
        loss1, gn1 = m1["loss"].clone(), m1["grad_norm"].clone()
        f2, m2 = fstep(f1, xs[s:], ys[s:], gens, dyn)
        worst = {"loss1": 0.0, "gnorm1": 0.0, "loss2": 0.0, "far": 0.0}

        def two_single_steps(seed, u, plain=False, f64=False):
            mm = build_model("mnist", dim=MNIST_DIM,
                             generator=torch.Generator().manual_seed(seed))
            if f64:
                mm.double()
            st = create_train_state(mm, opt)
            step = make_train_step(mm, opt, [ref_solver], opts,
                                   use_kernels=not plain)
            g = torch.Generator().manual_seed(seed)
            sv = u_solver(u)
            if f64:
                sv = [sv[0].replace(u=sv[0].u.double())]
            cast = (lambda t: t.double()) if f64 else (lambda t: t)
            i = members.index((u, seed))
            st, a = step(st, cast(xs[i]), ys[i], g, sv)
            st, b = step(st, cast(xs[s + i]), ys[s + i], g, sv)
            return a, b, st

        for i, (u, seed) in enumerate(members):
            a, b, st = two_single_steps(seed, u)
            rel = lambda x, y: abs(x - y) / max(abs(y), 1e-12)  # noqa: E731
            worst["loss1"] = max(worst["loss1"], rel(loss1[i].item(),
                                                     a["loss"].item()))
            worst["gnorm1"] = max(worst["gnorm1"], rel(gn1[i].item(),
                                                       a["grad_norm"].item()))
            worst["loss2"] = max(worst["loss2"], rel(m2["loss"][i].item(),
                                                     b["loss"].item()))
            worst["far"] = max(worst["far"], params_apart(
                {k: v[i] for k, v in f2.params.items()}, st.params)[0])
        # the witness: member 0's single run, plain path, f32 against f64
        a32, b32, st32 = two_single_steps(seed0, u0, plain=True)
        a64, b64, st64 = two_single_steps(seed0, u0, plain=True, f64=True)
        witness = {"loss1": abs(a32["loss"].item() - a64["loss"].item())
                   / abs(a64["loss"].item()),
                   "loss2": abs(b32["loss"].item() - b64["loss"].item())
                   / abs(b64["loss"].item()),
                   "far": params_apart(st32.params, {
                       k: v.float() for k, v in st64.params.items()})[0]}
    print(f"  each member against its single run (kernel paths, two steps "
          f"from one state; the fleet's stem and strided convs are one "
          f"grouped cuDNN conv and its head a bmm): step 1 loss relative "
          f"{worst['loss1']:.3e} (bar {FLEET_LOSS1_BAR}), grad norm "
          f"{worst['gnorm1']:.3e} (bar {FLEET_GNORM1_BAR}); step 2 loss "
          f"{worst['loss2']:.3e} (bar {FLEET_LOSS2_BAR}), params more than "
          f"1e-4 max|p| apart {worst['far']:.3e} of them (bar "
          f"{FLEET_FAR_SHARE_BAR})", flush=True)
    print(f"  witness, rounding alone (member 0's single run, plain path "
          f"f32 against f64): step 1 loss {witness['loss1']:.3e}, step 2 "
          f"loss {witness['loss2']:.3e}, params apart "
          f"{witness['far']:.3e}", flush=True)
    if not (worst["loss1"] <= FLEET_LOSS1_BAR
            and worst["gnorm1"] <= FLEET_GNORM1_BAR
            and worst["loss2"] <= FLEET_LOSS2_BAR
            and worst["far"] <= FLEET_FAR_SHARE_BAR):
        fail(f"fleet members differ from their single runs: {worst}")
    del fts, f1, f2, st, st32, st64
    torch.cuda.empty_cache()

    # fleet kernel path against fleet plain path, phase 11's bars
    res = {}
    for use_kernels in (True, False):
        fts_k, gens_k, dyn_k, step_k = fleet_of(s, use_kernels)
        _, mk = step_k(fts_k, xs[:s], ys[:s], gens_k, dyn_k)
        res[use_kernels] = (mk["loss"], mk["grad_norm"])
        del fts_k
    (lk, nk), (lp, np_) = res[True], res[False]
    loss_gap = ((lk - lp).abs() / lp.abs().clamp(min=1.0)).max().item()
    norm_gap = ((nk - np_).abs() / np_).max().item()
    print(f"  fleet kernel path vs fleet plain path: loss |diff| "
          f"{loss_gap:.3e} of max(1, |loss|) (bar 2e-2), grad norm "
          f"relative {norm_gap:.3e} (bar 5e-2)", flush=True)
    if not (loss_gap <= 2e-2 and norm_gap <= 5e-2):
        fail("the fleet's kernel and plain paths disagree")
    torch.cuda.empty_cache()

    # one step under PGD-7 (u_sweep --adv_training_mode at): B3's dx-only
    # backward and the dgrad member-batched in the attack's passes
    matk = AttackConfig(mode="at", eps=PGD_EPS, pgd_lr=PGD_LR,
                        pgd_niter=PGD_ITERS)
    fts_a, gens_a, dyn_a, step_a = fleet_of(s, attack=matk)
    port.reset_launch_counts()
    t0 = time.perf_counter()
    _, ma = step_a(fts_a, xs[:s], ys[:s], gens_a, dyn_a)
    torch.cuda.synchronize()
    pgd_ms = (time.perf_counter() - t0) * 1e3
    pgd_counts = dict(port.launch_counts())
    print(f"  one PGD-{PGD_ITERS} fleet step (the first of its step "
          f"function, allocations included): {pgd_ms:.1f} ms, launches "
          f"{pgd_counts} (a single step's {MNIST_TRAIN_PER_STEP})",
          flush=True)
    if not torch.isfinite(ma["loss"]).all():
        fail(f"non-finite PGD fleet losses {ma['loss'].tolist()}")
    if pgd_counts != MNIST_TRAIN_PER_STEP:
        fail(f"a PGD fleet step launches {pgd_counts}, a single one "
             f"{MNIST_TRAIN_PER_STEP}")
    del fts_a
    torch.cuda.empty_cache()
    return {"members": s, "counts": fcounts,
            "launches_per_step": fleet_per_step,
            "single_launches_per_step": single_per_step,
            "step_ms": fleet_ms, "single_step_ms": single_ms,
            "single_step_ms_x_members": s * single_ms,
            "img_s": s * n / fleet_ms * 1e3, "peak_gib": peak,
            "chunk_sizes": sizes, "member_vs_single": worst,
            "witness_f32_vs_f64": witness,
            "kernel_vs_plain": {"loss": loss_gap, "grad_norm": norm_gap},
            "pgd_step_ms": pgd_ms, "pgd_launches": pgd_counts}


def fleet_cli_phase(port, torch, dev):
    """Phase 25: u_sweep at full width, sequential and --fleet, and sweep
    over two grid points of mnist_runner.  Returns the launches of the
    runs and the wall seconds."""
    import csv
    import tempfile

    from neural_ode_metasolver_tpu_torch.runners import sweep, u_sweep

    phase(f"u_sweep (u {USWEEP_U} x seeds {USWEEP_SEEDS}, MNIST dim "
          f"{MNIST_DIM}, {RUNNER_MNIST_TRAIN} train and {RUNNER_MNIST_TEST} "
          f"test synthetic images, 1 epoch), sequential and --fleet; sweep "
          f"over 2 grid points of mnist_runner")
    out = {}
    port.reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--u_grid", USWEEP_U, "--seeds", USWEEP_SEEDS,
                "--n_steps", str(N_STEPS), "--nepochs", "1",
                "--batch_size", str(FLEET_N), "--dim", str(MNIST_DIM),
                "--synthetic_test_size", str(RUNNER_MNIST_TEST)]
        tables = {}
        for label, train, extra in (
                ("sequential", RUNNER_MNIST_TRAIN, []),
                ("fleet", RUNNER_MNIST_TRAIN, ["--fleet"]),
                ("held sequential", USWEEP_HELD_TRAIN, []),
                ("held fleet", USWEEP_HELD_TRAIN,
                 ["--fleet", "--fleet_chunk", str(USWEEP_HELD_CHUNK)])):
            path = os.path.join(tmp, f"{label.replace(' ', '_')}.csv")
            t0 = time.perf_counter()
            u_sweep.main(argv + ["--synthetic_train_size", str(train),
                                 "--output_csv", path] + extra)
            torch.cuda.synchronize()
            out[f"{label}_s"] = time.perf_counter() - t0
            with open(path) as f:
                reader = csv.DictReader(f)
                rows = list(reader)
            if reader.fieldnames != u_sweep.CSV_COLUMNS or len(rows) != 8:
                fail(f"u_sweep {label}: {reader.fieldnames}, {len(rows)} "
                     f"rows")
            tables[label] = {(r["u0"], r["seed"]): r for r in rows}
            print(f"  u_sweep {label} ({train} train images): "
                  f"{out[label + '_s']:.1f} s wall; "
                  + "; ".join(f"u {r['u0']} seed {r['seed']}: clean "
                              f"{float(r['clean_acc']):.4f} PGD "
                              f"{float(r['robust_acc']):.4f}"
                              for r in rows), flush=True)
        if any(set(t) != set(tables["sequential"]) for t in tables.values()):
            fail(f"u_sweep: the runs' rows differ: "
                 f"{ {k: sorted(t) for k, t in tables.items()} }")
        if not all(0.0 <= float(r["robust_acc"]) <= 1.0
                   for t in tables.values() for r in t.values()):
            fail("u_sweep: a robust accuracy lies outside [0, 1]")

        def apart(a, b, col):  # the most test images two runs differ by
            return max(round(abs(float(a[k][col]) - float(b[k][col]))
                             * RUNNER_MNIST_TEST) for k in a)

        seq, flt = tables["sequential"], tables["fleet"]
        hseq, hflt = tables["held sequential"], tables["held fleet"]
        out["clean_gap"] = apart(seq, flt, "clean_acc") / RUNNER_MNIST_TEST
        held = {col: apart(hseq, hflt, col)
                for col in ("clean_acc", "robust_acc")}
        out["held_apart"] = held
        distinct = len({r["clean_acc"] for r in hseq.values()})
        print(f"  fleet against sequential, {RUNNER_MNIST_TRAIN} train "
              f"images: clean accuracy at most {out['clean_gap']:.4f} apart "
              f"(not held); fleet {out['sequential_s'] / out['fleet_s']:.2f}"
              f"x faster in wall time", flush=True)
        print(f"  fleet against sequential, {USWEEP_HELD_TRAIN} train "
              f"images: clean at most {held['clean_acc']}, PGD at most "
              f"{held['robust_acc']} of {RUNNER_MNIST_TEST} test images apart "
              f"(bar {USWEEP_HELD_BAR}); {distinct} distinct clean "
              f"accuracies among the members", flush=True)
        if max(held.values()) > USWEEP_HELD_BAR:
            fail(f"u_sweep: fleet and sequential disagree after two steps "
                 f"a member: {held} test images apart")
        if distinct < 2:
            fail("u_sweep: every member reads one clean accuracy, so the "
                 "fleet-against-sequential check cannot see a member's "
                 "rows mixed up")
        out["usweep_counts"] = dict(port.launch_counts())

        cfg = os.path.join(tmp, "sweep.json")
        with open(cfg, "w") as f:
            json.dump({"parameters": {"wnb_u": {"values": [0.5, 1.0]}}}, f)
        base = digits_runner_argv(os.path.join(tmp, "unused"))
        base[base.index("--save_dir"):] = []
        t0 = time.perf_counter()
        records = sweep.main(["--runner", "mnist", "--config", cfg,
                              "--sweep_dir", os.path.join(tmp, "sweep"),
                              "--", "--nepochs", "1"] + base)
        out["sweep_s"] = time.perf_counter() - t0
        with open(os.path.join(tmp, "sweep", "sweep_summary.csv")) as f:
            summary = list(csv.DictReader(f))
        print(f"  sweep: {len(records)} runs in {out['sweep_s']:.1f} s; "
              f"summary {[(r['wnb_u'], r['best'], r['error']) for r in summary]}",
              flush=True)
        if len(records) != 2 or len(summary) != 2 or any(
                r["error"] or r["best"] is None for r in records):
            fail(f"sweep: {records}")
        for r in records:
            check_checkpoint_dir(os.path.join(r["run_dir"], "last"))
    out["counts"] = dict(port.launch_counts())
    return out


# Phase 26: the served models exported with torch.export and loaded in a
# fresh process.  (name, build_model keywords, image shape, compute dtype
# name, launches a request by kernel)
EXPORTS = [
    ("mnist", {"dim": MNIST_DIM}, (28, 28, 1), "float32",
     {"group_norm_act": MNIST_GN_PER_PASS,
      "conv3x3_same": MNIST_B1_PER_PASS}),
    ("premetanode10", {"in_planes": 64}, (32, 32, 3), "bfloat16",
     {"conv3x3_same": len(B1_CALLS),
      "ode_block_rk2": len(B2_CALLS) * B2_LAUNCHES_PER_SOLVE}),
]
EXPORT_BATCHES = (1, 64, BATCH)
# each kernel's custom op (ops/library.py), by its launch counter
OPS = {"conv3x3_same": "nodems::conv3x3_same",
       "ode_block_rk2": "nodems::ode_block_rk2",
       "group_norm_act": "nodems::group_norm_act",
       "gelu_poly": "nodems::gelu_poly"}
# what each op of a graph launches: B2's op is one whole solve
OP_LAUNCHES = {"conv3x3_same": 1, "group_norm_act": 1,
               "ode_block_rk2": B2_LAUNCHES_PER_SOLVE}
# The loading process: it imports the port's serving module alone (and so
# the op registration), loads each artifact, serves the saved requests
# (a warm-up, then REQUEST_ROUNDS counted and timed requests a batch size)
# and saves their logits; one JSON line out.
LOADED_SERVER = r"""
import json, os, sys, time
spec = json.loads(sys.argv[1])
sys.path.insert(0, spec["repo"])
import torch
from neural_ode_metasolver_tpu_torch import backend, serving
out = {"models_imported": None, "runs": []}
for run in spec["runs"]:
    t0 = time.perf_counter()
    served = serving.load_model(run["path"], run["device"])
    load_s = time.perf_counter() - t0
    row = {"label": run["label"], "load_s": load_s, "batches": []}
    for b in run["batches"]:
        x = torch.load(os.path.join(spec["dir"], f"x_{run['model']}_{b}.pt"))
        served(x)
        torch.cuda.synchronize()
        ms, counts = [], []
        for _ in range(spec["rounds"]):
            backend.reset_launch_counts()
            t0 = time.perf_counter()
            y = served(x)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            counts.append(backend.launch_counts())
        torch.save(y.cpu(), os.path.join(
            spec["dir"], f"y_{run['label']}_{b}.pt"))
        row["batches"].append({"batch": b, "ms": sorted(ms),
                               "counts": counts})
    out["runs"].append(row)
out["models_imported"] = "neural_ode_metasolver_tpu_torch.models" in sys.modules
print(json.dumps(out))
"""


def export_phase(port, torch, dev):
    """Phase 26: export the MNIST MetaNODE (dim 64, f32) and premetanode10
    (in_planes 64, bf16) with ``serving.export_model`` on the card, with a
    dynamic batch, and the MNIST one on the CPU too; load each in a fresh
    process that imports only ``serving`` (the card's artifacts on the
    card, the CPU's moved onto the card, and the card's MNIST one moved to
    the CPU for batch 1); serve batch 1, 64 and 256 against the live
    ``ServedModel`` on the same inputs: logits within the serving bars
    (f32 1e-4 max(1, max|logit|), bf16 2^-5 max|logit|), launches per
    request equal to the live path's at every size, each graph's nodems
    ops as many as the live path's launches, export and load seconds,
    artifact MB, ms and img/s of both paths.  Returns phase 26's record
    for the kernels line."""
    import tempfile

    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.serving import (
        ServedModel,
        export_model,
    )

    phase(f"export the served models with torch.export (MNIST dim "
          f"{MNIST_DIM} f32, premetanode10 in_planes 64 bf16) and serve "
          f"them from a fresh process, batch {EXPORT_BATCHES}")
    solvers = parse_solver_dsl(f"rk2,u,{N_STEPS},-1,{U},-1")
    gen = torch.Generator().manual_seed(26)
    record = {"paths": {}, "counts": Counter(), "requests": 0}
    with tempfile.TemporaryDirectory() as tmp:
        runs, live = [], {}
        for name, kw, shape, dtype, per_request in EXPORTS:
            model = build_model(name, generator=torch.Generator(
                ).manual_seed(0), **kw)
            cdt = getattr(torch, dtype)
            served = ServedModel(model, solvers, SolverOptions(),
                                 compute_dtype=cdt)
            for b in EXPORT_BATCHES:
                x = torch.rand(b, *shape, generator=gen)
                torch.save(x, os.path.join(tmp, f"x_{name}_{b}.pt"))
                served(x)  # warm-up
                torch.cuda.synchronize()
                ms = []
                for _ in range(REQUEST_ROUNDS):
                    t0 = time.perf_counter()
                    y = served(x)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                live[(name, b)] = (y.cpu(), sorted(ms))
            targets = [("cuda", model)]
            if name == "mnist":  # the move onto the card
                targets.append(("cpu", build_model(
                    name, device="cpu",
                    generator=torch.Generator().manual_seed(0), **kw)))
            for where, m in targets:
                path = os.path.join(tmp, f"{name}_{where}")
                t0 = time.perf_counter()
                export_model(path, m, solvers, SolverOptions(),
                             input_shape=(1,) + shape, compute_dtype=cdt,
                             config={"model": name, **kw})
                export_s = time.perf_counter() - t0
                program = torch.export.load(os.path.join(path, "model.pt2"))
                ops = Counter(
                    str(n.target).split(".")[1] for n in program.graph.nodes
                    if n.op == "call_function"
                    and str(n.target).startswith("nodems."))
                graph_launches = {k: v * OP_LAUNCHES[k]
                                  for k, v in ops.items()}
                mb = os.path.getsize(os.path.join(path, "model.pt2")) / 1e6
                label = f"{name}_{where}"
                print(f"  {label}: export {export_s:.2f} s, artifact "
                      f"{mb:.2f} MB, nodems ops in the graph {dict(ops)} = "
                      f"{graph_launches} launches a request", flush=True)
                if graph_launches != per_request:
                    fail(f"{label}: the graph's ops launch "
                         f"{graph_launches}, the live path {per_request}")
                record["paths"][label] = {"export_s": export_s,
                                          "artifact_mb": mb,
                                          "graph_ops": dict(ops)}
                runs.append({"label": label, "model": name,
                             "path": path, "device": "cuda",
                             "batches": list(EXPORT_BATCHES)})
            if name == "mnist":  # the card's artifact moved to the CPU
                runs.append({"label": "mnist_cuda_on_cpu", "model": name,
                             "path": os.path.join(tmp, "mnist_cuda"),
                             "device": "cpu", "batches": [1]})
            del model, served
            torch.cuda.empty_cache()
        spec = {"repo": REPO, "dir": tmp, "rounds": REQUEST_ROUNDS,
                "runs": runs}
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", LOADED_SERVER,
                               json.dumps(spec)], capture_output=True,
                              text=True, timeout=600)
        proc_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"the loading process failed: {proc.stderr[-4000:]}")
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"  loading process: {proc_s:.1f} s; it imported the models "
              f"package: {out['models_imported']}", flush=True)
        if out["models_imported"]:
            fail("loading an artifact imported the model-building code")
        by_name = {e[0]: e for e in EXPORTS}
        for run in out["runs"]:
            name = run["label"].split("_")[0]
            _, _, _, dtype, per_request = by_name[name]
            on_card = not run["label"].endswith("on_cpu")
            rec = record["paths"].setdefault(run["label"], {})
            rec["load_s"] = run["load_s"]
            rec["batches"] = []
            for row in run["batches"]:
                b = row["batch"]
                y_live, live_ms = live[(name, b)]
                y = torch.load(os.path.join(
                    tmp, f"y_{run['label']}_{b}.pt"))
                err = (y - y_live).abs().max().item()
                top = y_live.abs().max().item()
                bar = (1e-4 * max(1.0, top) if dtype == "float32"
                       else 2.0 ** -5 * top)
                counts = row["counts"]
                ms = row["ms"][len(row["ms"]) // 2]
                lms = live_ms[len(live_ms) // 2]
                print(f"  {run['label']} batch {b}: loaded {ms:.3f} ms "
                      f"({b / ms * 1e3:.1f} img/s) vs live {lms:.3f} ms "
                      f"({b / lms * 1e3:.1f} img/s); max|diff| {err:.3e} "
                      f"(bar {bar:.3e}), bit-equal "
                      f"{bool(torch.equal(y, y_live))}; launches a request "
                      f"{counts[0]}", flush=True)
                if y.shape != y_live.shape or not err <= bar:
                    fail(f"{run['label']} batch {b}: logits {tuple(y.shape)}"
                         f" {err} apart from the live path (bar {bar})")
                want = per_request if on_card else {}
                if any(c != want for c in counts):
                    fail(f"{run['label']} batch {b}: launches {counts}, "
                         f"the live path's {want} a request")
                for c in counts:
                    record["counts"].update(c)
                rec["batches"].append({
                    "batch": b, "ms": ms, "live_ms": lms,
                    "img_s": b / ms * 1e3, "live_img_s": b / lms * 1e3,
                    "max_abs_err": err, "bar": bar,
                    "bit_equal": bool(torch.equal(y, y_live)),
                    "launches_a_request": counts[0]})
            if on_card:
                record["requests"] += REQUEST_ROUNDS * len(run["batches"])
    record["counts"] = dict(record["counts"])
    return record


# Phase 27: phase 24's fleet recipe (16 members, 4 u x 4 seeds, MNIST dim
# 64, batch 128 a member, f32, RK2 8 steps, RMSprop 1e-3 wd 5e-4, clean)
# under the Evaluate notebook's switch[0.6,0.4] and solver_ens[0.6,0.4]
# (ensemble_prob 1) over two noised RK2 solvers: the grid's model-
# ensembling pair around u=0.5 (the original and a Normal(0.2)-noised copy,
# ``notebook_regime_grid``), shifted to each member's u.  The pair shares
# its statics, so a switch whose members chose apart is one solve on their
# stacked tableau: a switch step launches a standalone step's, a solver_ens
# step (every coin up) one more solve's worth each way.
REGIME_FLEET_GRID_SEED = 15  # scripts/digits_regimes_eval.py's grid key
REGIME_FLEET_OPTIONS = (
    ("switch[0.6,0.4]", dict(solver_mode="switch", switch_probs=[0.6, 0.4]),
     1),
    ("solver_ens[0.6,0.4]", dict(solver_mode="ensemble", ensemble_prob=1.0,
                                 ensemble_weights=[0.6, 0.4]), 2),
)
MNIST_CLEAN_STEP = {"group_norm_act": MNIST_GN_PER_PASS,
                    "group_norm_act_bwd": MNIST_GN_PER_PASS,
                    "group_norm_act_bwd_params": MNIST_GN_PER_PASS,
                    "conv3x3_same": MNIST_B1_PER_PASS,
                    "conv3x3_dgrad": MNIST_B1_PER_PASS,
                    "conv3x3_wgrad": MNIST_B1_PER_PASS}
# one more ODE solve in a clean step: its RHS calls' three GroupNorms and
# two convs, both ways
MNIST_SOLVE_STEP = {"group_norm_act": 3 * MNIST_RHS,
                    "group_norm_act_bwd": 3 * MNIST_RHS,
                    "group_norm_act_bwd_params": 3 * MNIST_RHS,
                    "conv3x3_same": 2 * MNIST_RHS,
                    "conv3x3_dgrad": 2 * MNIST_RHS,
                    "conv3x3_wgrad": 2 * MNIST_RHS}
# the backoff fleet: Adam 1e-3 with nan_backoff 0.5 and skip_nonfinite, one
# member a u, member BACKOFF_BAD's batch NaN at step 0 of BACKOFF_STEPS.
# Each member's counts, scale and n_skipped must equal its single run's, its
# losses be within phase 24's bars of them (step 1 FLEET_LOSS1_BAR, later
# FLEET_LOSS2_BAR) and its params more than 1e-4 max|p| apart no more often
# than phase 24's bar or rounding alone moves them, whichever is larger:
# Adam's update is about lr sign(g), so three steps of the u=0.25 member's
# single run, plain path in f32 against f64, move 0.27 of the params that
# far (PR 16's chip run), while the members that differ read 0.014 at most
BACKOFF_LR, BACKOFF_FACTOR, BACKOFF_STEPS, BACKOFF_BAD = 1e-3, 0.5, 3, 1


def regime_fleet_phase(port, torch, dev, standalone_fleet_ms):
    """Phase 27: phase 24's fleet under switch[0.6,0.4] and
    solver_ens[0.6,0.4]: finite losses, the launches a step (a single
    step's whose draws take the same branches), ms a step beside phase
    24's standalone fleet, each member against its single run over two
    steps from one state with its draws (phase 24's bars), the kernel path
    against the plain path (phase 11's bars); then a fleet under Adam with
    the non-finite backoff and skip_nonfinite, one member's batch NaN at
    step 0 of three: each member's counts, scale, n_skipped and params
    against its single run.  Returns the phase's record."""
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                     create_solver)
    from neural_ode_metasolver_tpu_torch.ops.regimes import _choose
    from neural_ode_metasolver_tpu_torch.training import (
        create_fleet_state, create_train_state, fleet_generators,
        fleet_member, make_fleet_train_step, make_optimizer,
        make_train_step, notebook_regime_grid, stack_fleet_solvers)
    from neural_ode_metasolver_tpu_torch.training.train import (
        _regime_seeds, _seeds)

    s, n = FLEET_S, FLEET_N
    members = [(u, seed) for u in FLEET_US for seed in FLEET_SEEDS]
    ref_solver = create_solver("rk2", "u", n_steps=N_STEPS, u0=U)
    grid = notebook_regime_grid(
        ref_solver, torch.Generator().manual_seed(REGIME_FLEET_GRID_SEED))
    pair = next(g for g in grid if g.is_model_ensemble).solvers
    offsets = [float(p.u) - U for p in pair]
    member_pairs = [[ref_solver.replace(u=torch.tensor(
        u + d, dtype=torch.float32)) for d in offsets] for u, _ in members]
    phase(f"train: phase 24's fleet of {s} under switch[0.6,0.4] and "
          f"solver_ens[0.6,0.4] over the notebook grid's noised pair "
          f"(u {U} + {offsets}) shifted to each member's u")
    opt = make_optimizer("rmsprop", FLEET_LR, weight_decay=5e-4)
    model = build_model("mnist", dim=MNIST_DIM)
    gcpu = torch.Generator().manual_seed(27)
    xs = torch.rand(2 * s, n, 28, 28, 1, generator=gcpu).to(dev)
    ys = torch.randint(0, 10, (2 * s, n), generator=gcpu).to(dev)
    dyn = stack_fleet_solvers(member_pairs)
    seeds = [seed for _, seed in members]
    record = {"members": s, "regimes": {}, "counts": Counter()}

    def fresh(options, use_kernels=True):
        # the init draws consume their generators; the step gets fresh
        # ones, as each single run's step does
        fts = create_fleet_state(model, opt, fleet_generators(seeds))
        return fts, make_fleet_train_step(model, opt, member_pairs[0],
                                          options, use_kernels=use_kernels)

    def train_draw(seed, options):
        # member seed's training-forward draw at step 1 (its fifth seed)
        g = torch.Generator().manual_seed(seed)
        _seeds(g, 3)
        fwd = torch.Generator().manual_seed(_regime_seeds(g, options, 2)[1])
        if options.solver_mode == "switch":
            return _choose(fwd, options.switch_probs)
        return bool(float(torch.rand((), generator=fwd,
                                     dtype=torch.float64))
                    < options.ensemble_prob)

    rel = lambda x, y: abs(x - y) / max(abs(y), 1e-12)  # noqa: E731
    for label, kw, solves in REGIME_FLEET_OPTIONS:
        options = SolverOptions(**kw)
        want = {k: v + (solves - 1) * MNIST_SOLVE_STEP[k]
                for k, v in MNIST_CLEAN_STEP.items()}
        fts, step = fresh(options)
        gens = fleet_generators(seeds)
        step(fts, xs[:s], ys[:s], gens, dyn)  # warm-up
        torch.cuda.synchronize()
        port.reset_launch_counts()
        ms = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            _, m = step(fts, xs[:s], ys[:s], gens, dyn)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        counts = port.launch_counts()
        record["counts"].update(counts)
        per_step = {k: v // TRAIN_STEPS for k, v in counts.items()}
        med = sorted(ms)[len(ms) // 2]
        draws = [train_draw(seed, options) for seed in seeds]
        print(f"  {label}: median {med:.3f} ms a step ({s * n / med * 1e3:.1f}"
              f" img/s over all members) against phase 24's standalone "
              f"fleet {standalone_fleet_ms:.3f} ms "
              f"({med / standalone_fleet_ms:.2f}x); "
              f"launches a step {per_step} (want {want}); the members' "
              f"training draws at step 1 {draws}; last losses "
              f"{[round(v, 5) for v in m['loss'].tolist()]}", flush=True)
        if not torch.isfinite(m["loss"]).all():
            fail(f"{label}: non-finite fleet losses {m['loss'].tolist()}")
        if per_step != want:
            fail(f"{label}: a fleet step launches {per_step}, want {want}")
        del fts
        torch.cuda.empty_cache()

        # each member against its own single run: two steps, its draws,
        # cuDNN deterministic on both sides
        with deterministic_cudnn(torch):
            fts, step = fresh(options)
            gens = fleet_generators(seeds)
            f1, m1 = step(fts, xs[:s], ys[:s], gens, dyn)
            loss1, gn1 = m1["loss"].clone(), m1["grad_norm"].clone()
            f2, m2 = step(f1, xs[s:], ys[s:], gens, dyn)
            worst = {"loss1": 0.0, "gnorm1": 0.0, "loss2": 0.0, "far": 0.0,
                     "max_param_diff_of_max_p": 0.0}
            for i, (u, seed) in enumerate(members):
                mm = build_model("mnist", dim=MNIST_DIM,
                                 generator=torch.Generator().manual_seed(seed))
                st = create_train_state(mm, opt)
                sstep = make_train_step(mm, opt, member_pairs[i], options)
                g = torch.Generator().manual_seed(seed)
                st, a = sstep(st, xs[i], ys[i], g, member_pairs[i])
                st, b = sstep(st, xs[s + i], ys[s + i], g, member_pairs[i])
                far, top = params_apart(
                    {k: v[i] for k, v in f2.params.items()}, st.params)
                worst["loss1"] = max(worst["loss1"], rel(loss1[i].item(),
                                                         a["loss"].item()))
                worst["gnorm1"] = max(worst["gnorm1"], rel(
                    gn1[i].item(), a["grad_norm"].item()))
                worst["loss2"] = max(worst["loss2"], rel(m2["loss"][i].item(),
                                                         b["loss"].item()))
                worst["far"] = max(worst["far"], far)
                worst["max_param_diff_of_max_p"] = max(
                    worst["max_param_diff_of_max_p"], top)
                del mm, st
        print(f"  {label}, each member against its single run (two steps "
              f"from one state, its draws): step 1 loss relative "
              f"{worst['loss1']:.3e} (bar {FLEET_LOSS1_BAR}), grad norm "
              f"{worst['gnorm1']:.3e} (bar {FLEET_GNORM1_BAR}); step 2 loss "
              f"{worst['loss2']:.3e} (bar {FLEET_LOSS2_BAR}), params more "
              f"than 1e-4 max|p| apart {worst['far']:.3e} of them (bar "
              f"{FLEET_FAR_SHARE_BAR}), largest param difference "
              f"{worst['max_param_diff_of_max_p']:.3e} of max|p|",
              flush=True)
        if not (worst["loss1"] <= FLEET_LOSS1_BAR
                and worst["gnorm1"] <= FLEET_GNORM1_BAR
                and worst["loss2"] <= FLEET_LOSS2_BAR
                and worst["far"] <= FLEET_FAR_SHARE_BAR):
            fail(f"{label}: fleet members differ from their single runs: "
                 f"{worst}")
        del fts, f1, f2
        torch.cuda.empty_cache()

        # the fleet's kernel path against its plain path, phase 11's bars
        res = {}
        for use_kernels in (True, False):
            fts, step = fresh(options, use_kernels)
            _, mk = step(fts, xs[:s], ys[:s], fleet_generators(seeds), dyn)
            res[use_kernels] = (mk["loss"], mk["grad_norm"])
            del fts
        (lk, nk), (lp, np_) = res[True], res[False]
        loss_gap = ((lk - lp).abs() / lp.abs().clamp(min=1.0)).max().item()
        norm_gap = ((nk - np_).abs() / np_).max().item()
        print(f"  {label}, fleet kernel path vs plain path: loss |diff| "
              f"{loss_gap:.3e} of max(1, |loss|) (bar 2e-2), grad norm "
              f"relative {norm_gap:.3e} (bar 5e-2)", flush=True)
        if not (loss_gap <= 2e-2 and norm_gap <= 5e-2):
            fail(f"{label}: the fleet's kernel and plain paths disagree")
        torch.cuda.empty_cache()
        record["regimes"][label] = {
            "step_ms": med, "img_s": s * n / med * 1e3,
            "standalone_fleet_step_ms": standalone_fleet_ms,
            "launches_per_step": per_step, "want_per_step": want,
            "train_draws_step1": draws, "member_vs_single": worst,
            "kernel_vs_plain": {"loss": loss_gap, "grad_norm": norm_gap}}

    # the backoff fleet: one member a u, member BACKOFF_BAD NaN at step 0
    bopt = make_optimizer("adam", BACKOFF_LR,
                          nonfinite_backoff=BACKOFF_FACTOR)
    bseed = FLEET_SEEDS[0]
    bx = [xs[k * len(FLEET_US):(k + 1) * len(FLEET_US)].clone()
          for k in range(BACKOFF_STEPS)]
    bx[0][BACKOFF_BAD, 0, 0, 0, 0] = float("nan")
    by = [ys[k * len(FLEET_US):(k + 1) * len(FLEET_US)]
          for k in range(BACKOFF_STEPS)]
    usolvers = [[ref_solver.replace(u=torch.tensor(u, dtype=torch.float32))]
                for u in FLEET_US]
    bgens = [bseed] * len(FLEET_US)
    bfts = create_fleet_state(model, bopt, fleet_generators(bgens))
    bstep = make_fleet_train_step(model, bopt, [ref_solver],
                                  SolverOptions(), skip_nonfinite=True)
    gens = fleet_generators(bgens)
    skipped, flosses = [], []
    for k in range(BACKOFF_STEPS):
        bfts, bm = bstep(bfts, bx[k], by[k], gens,
                         stack_fleet_solvers(usolvers))
        skipped.append(bm["skipped_nonfinite"].tolist())
        flosses.append(bm["loss"].tolist())

    def single_run(i, plain=False, f64=False):
        mm = build_model("mnist", dim=MNIST_DIM,
                         generator=torch.Generator().manual_seed(bseed))
        sv = usolvers[i]
        if f64:
            mm.double()
            sv = [sv[0].replace(u=sv[0].u.double())]
        st = create_train_state(mm, bopt)
        sstep = make_train_step(mm, bopt, [ref_solver], skip_nonfinite=True,
                                use_kernels=not plain)
        g = torch.Generator().manual_seed(bseed)
        losses = []
        for k in range(BACKOFF_STEPS):
            x = bx[k][i].double() if f64 else bx[k][i]
            st, m = sstep(st, x, by[k][i], g, sv)
            losses.append(m["loss"].item())
        return st, losses

    # rounding alone: member 0's single run, plain path, f32 against f64
    w32, _ = single_run(0, plain=True)
    w64, _ = single_run(0, plain=True, f64=True)
    witness, _ = params_apart(w32.params, {
        k: v.detach().float() for k, v in w64.params.items()})
    far_bar = max(FLEET_FAR_SHARE_BAR, witness)
    del w32, w64
    rows = []
    keys = ("count", "scale", "n_skipped")
    for i, u in enumerate(FLEET_US):
        st, losses = single_run(i)
        mine = fleet_member(bfts.opt_state, i)
        far, top = params_apart(
            {k: v[i] for k, v in bfts.params.items()}, st.params)
        gaps = [abs(flosses[k][i] - losses[k]) / abs(losses[k])
                for k in range(BACKOFF_STEPS) if math.isfinite(losses[k])]
        rows.append({"u": u, **{k: mine[k] for k in keys},
                     "single": {k: st.opt_state[k] for k in keys},
                     "loss_gaps": gaps, "far": far,
                     "max_param_diff_of_max_p": top})
        if any(mine[k] != st.opt_state[k] for k in keys):
            fail(f"backoff fleet member {i}: counts {mine} against its "
                 f"single run's {st.opt_state}")
        if gaps and (gaps[0] > FLEET_LOSS1_BAR
                     or max(gaps) > FLEET_LOSS2_BAR):
            fail(f"backoff fleet member {i}: losses {gaps} relative from "
                 "its single run's")
        if far > far_bar:
            fail(f"backoff fleet member {i}: {far:.3e} of the params more "
                 f"than 1e-4 max|p| from its single run's (bar {far_bar})")
        del st
    print(f"  backoff fleet (Adam {BACKOFF_LR}, nan_backoff "
          f"{BACKOFF_FACTOR}, skip_nonfinite; member {BACKOFF_BAD}'s batch "
          f"NaN at step 0 of {BACKOFF_STEPS}): skipped a step "
          f"{skipped}; each member's count, scale, n_skipped equal its "
          f"single run's: "
          f"{[(r['count'], r['scale'], r['n_skipped']) for r in rows]}; "
          f"losses relative at most "
          f"{max(max(r['loss_gaps']) for r in rows):.3e} (step 1 bar "
          f"{FLEET_LOSS1_BAR}, later {FLEET_LOSS2_BAR}); params more than "
          f"1e-4 max|p| apart at most {max(r['far'] for r in rows):.3e} of "
          f"them (bar {far_bar:.3e}: phase 24's {FLEET_FAR_SHARE_BAR} or "
          f"the witness, member 0's single run in f32 against f64, "
          f"{witness:.3e}), largest difference "
          f"{max(r['max_param_diff_of_max_p'] for r in rows):.3e} of "
          f"max|p|", flush=True)
    if [r["n_skipped"] for r in rows] != [int(i == BACKOFF_BAD)
                                          for i in range(len(FLEET_US))]:
        fail(f"backoff fleet: n_skipped {[r['n_skipped'] for r in rows]}")
    record["backoff"] = {"members": rows, "witness_f32_vs_f64": witness}
    record["counts"] = dict(record["counts"])
    del bfts, model
    torch.cuda.empty_cache()
    return record


# Phase 28: the three examples/torch scripts as subprocesses on the card
# (their default device), run together: MNIST on the shipped checkpoint in
# the port's format, CIFAR at in_planes 64, batch 256, 512 images, bf16, all
# four regimes, and the coefficient example at its default 400 steps.
EXAMPLE_RUNS = (
    ("mnist", "mnist_build_and_evaluate.py",
     ["--checkpoint", os.path.join("examples", "checkpoints",
                                   "mnist_digits_smoothing_torch")]),
    ("cifar10", "cifar10_build_and_evaluate.py",
     ["--in_planes", "64", "--batch_size", str(BATCH), "--n_eval", "512",
      "--precision", "bf16"]),
    ("learn_solver_coefficient", "learn_solver_coefficient.py", []),
)
EXAMPLE_MNIST_N_EVAL, EXAMPLE_MNIST_STEPS = 512, 8  # the script's defaults


def examples_phase(port, torch, dev):
    """Phase 28: run the examples, each must exit 0; print their
    accuracies, u, launches and wall seconds; the MNIST example's clean
    accuracy must equal the port's in-process ``accuracy`` on the same
    images.  Returns the phase's record."""
    from neural_ode_metasolver_tpu_torch.data import (batch_iterator,
                                                      synthetic_dataset)
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                     create_solver)
    from neural_ode_metasolver_tpu_torch.runners.common import (
        optimizer_from_saved_args)
    from neural_ode_metasolver_tpu_torch.training import (
        accuracy, create_train_state, load_checkpoint_config,
        restore_checkpoint)

    phase("examples: examples/torch/*.py as subprocesses on the card, run "
          "together")
    from concurrent.futures import ThreadPoolExecutor

    def run(script, args):
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.join(REPO, "examples", "torch",
                                              script)] + args,
                cwd=REPO, capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired:
            return None, time.perf_counter() - t0
        return proc, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(EXAMPLE_RUNS)) as pool:
        futures = {label: pool.submit(run, script, args)
                   for label, script, args in EXAMPLE_RUNS}
    records, counts = {}, Counter()
    for label, fut in futures.items():
        proc, wall = fut.result()
        if proc is None:
            fail(f"example {label} ran past 300 s")
        if proc.returncode != 0:
            fail(f"example {label} exited {proc.returncode}: "
                 f"{proc.stderr.strip()[-1500:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        rec["wall_s"] = wall
        records[label] = rec
        counts.update(rec["launches"])
    print(f"  all three in {time.perf_counter() - t0:.1f} s wall (wall_s: "
          f"each subprocess's, interpreter start included; seconds: its "
          f"own clock from main())", flush=True)
    for label, rec in records.items():
        body = {k: v for k, v in rec.items() if k not in ("example",)}
        print(f"  {label}: " + json.dumps(body), flush=True)
    mn = records["mnist"]
    if not mn["launches"].get("conv3x3_same") or not mn["launches"].get(
            "group_norm_act"):
        fail(f"the MNIST example launched {mn['launches']} on the card")
    cf = records["cifar10"]
    if set(cf["regimes"]) != {"standalone", "switch [0.6,0.4]",
                              "solver ens [0.6,0.4]", "model ensembling"}:
        fail(f"the CIFAR example's regimes {sorted(cf['regimes'])}")
    if not cf["launches"].get("ode_block_rk2") or not cf["launches"].get(
            "conv3x3_same"):
        fail(f"the CIFAR example launched {cf['launches']} on the card")
    lr = records["learn_solver_coefficient"]
    if not (math.isfinite(lr["final_loss"]) and lr["u"] != lr["u0"]):
        fail(f"the coefficient example: {lr}")

    # the MNIST example's clean accuracy against the port in-process
    ckpt = os.path.join(REPO, EXAMPLE_RUNS[0][2][1])
    cfg = load_checkpoint_config(ckpt)
    model = build_model("mnist", dim=int(cfg["dim"]))
    restore_checkpoint(ckpt, create_train_state(
        model, optimizer_from_saved_args(cfg["args"])))
    ds = synthetic_dataset(EXAMPLE_MNIST_N_EVAL, (28, 28, 1), seed=1)
    acc = accuracy(model, [create_solver("rk4", "u3",
                                         n_steps=EXAMPLE_MNIST_STEPS,
                                         u0=1 / 3)],
                   SolverOptions(), batch_iterator(ds, BATCH, shuffle=False))
    print(f"  MNIST example's clean accuracy {mn['clean_acc']} against the "
          f"port in-process on the same images {acc}", flush=True)
    if acc != mn["clean_acc"]:
        fail(f"the MNIST example's clean accuracy {mn['clean_acc']} is not "
             f"the in-process {acc}")
    del model
    torch.cuda.empty_cache()
    return {"runs": records, "counts": dict(counts),
            "mnist_in_process_clean_acc": acc}


# Phase 29: the members of a solver ensemble on the member axis (training/
# evaluate.py with mesh=, a one-rank ``ensemble`` mesh) beside the member
# loop: four members from solver_ensemble_by_noising (RK2 u=0.5, 8 steps,
# Normal(0.2), as JAX's test_mesh_sharded_ensemble_eval_matches_loop), clean
# and FGSM, the MNIST MetaNODE (dim 64, f32, eps 0.3) and premetanode10
# (in_planes 64, bf16, eps 8/255 with the CIFAR mean and std), two batches
# of 256 each.  The averaged probabilities of the two paths agree within
# 1e-5 (f32) or 2^-5 (bf16) of 1; the member path launches B1, its dgrad,
# B3 and B3's backward once where the loop launches them once a member, B2
# (no member axis) once a member either way.
ENS_MEMBERS, ENS_SIGMA, ENS_BATCHES = 4, 0.2, 2
ENS_PROB_BAR = {None: 1e-5, "bfloat16": 2.0 ** -5}
# the kernels with a member axis (B2 has none: once a member)
MEMBER_BATCHED = ("conv3x3_same", "conv3x3_dgrad", "group_norm_act",
                  "group_norm_act_bwd")
# Phase 30: data parallelism.  (a) and (b) run mnist_runner at the digits
# width (dim 64, global batch 128, SGD lr 0.05, clean, 2 epochs of 10
# steps on 1280 synthetic images, validation on 256) as subprocesses on
# the one card; (c) the flagship step of phase 9 at batch 256 as two ranks
# of 128; (d) phase 29's MNIST ensemble as two ranks of two members.
DP_TRAIN, DP_TEST, DP_EPOCHS = 1280, 256, 2
# (b) holds phase 24's bars over two steps (two epochs of one batch), as
# phase 24 holds a fleet member over two steps: past them rounding grows
# with every step (ReLU masks flip on it), so the 20-step pair is printed
# beside a witness, the one-process run again with cuDNN free to order
# its sums by atomics (two such runs of one program read their second
# epoch's losses 7e-4 apart on an H100 80GB HBM3)
DP_HELD_TRAIN = MNIST_TRAIN_BATCH
DP_BF16_STEPS = 3
DP_GRAD_BAR = 1e-4  # of max|g|: the reduced f32 gradient against one process
DP_TIMEOUT_S = 300


def dp_runner_argv(save_dir, train=DP_TRAIN):
    """mnist_runner's flags for phase 30's runs."""
    return ["--solvers", f"rk2,u,{N_STEPS},-1,{U},-1", "--optim", "sgd",
            "--lr", "0.05", "--batch_size", str(MNIST_TRAIN_BATCH),
            "--test_batch_size", str(DP_TEST), "--nepochs", str(DP_EPOCHS),
            "--synthetic_train_size", str(train),
            "--synthetic_test_size", str(DP_TEST), "--save_dir", save_dir]


def ensemble_members(torch, model):
    """Phase 29's members on ``model``: the noised solvers, one each."""
    from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                     create_solver)
    from neural_ode_metasolver_tpu_torch.ops.noise import (
        solver_ensemble_by_noising)

    noised = solver_ensemble_by_noising(
        create_solver("rk2", "u", n_steps=N_STEPS, u0=U),
        torch.Generator().manual_seed(29), ensemble_size=ENS_MEMBERS,
        std=ENS_SIGMA, noise_type="normal")
    return [(model, [s], SolverOptions()) for s in noised]


def ensemble_mnist(torch, dev):
    """Phase 29's MNIST model and batches (seeded)."""
    from neural_ode_metasolver_tpu_torch.models import build_model

    model = build_model("mnist", dim=MNIST_DIM,
                        generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(29)
    data = [(torch.rand(BATCH, 28, 28, 1, generator=g).to(dev),
             torch.randint(0, 10, (BATCH,), generator=g).to(dev))
            for _ in range(ENS_BATCHES)]
    return model, data


def ensemble_mesh_phase(port, torch, dev):
    """Phase 29.  Returns the phase's record: per model the probabilities
    apart, the accuracies and ms a batch both ways, the launches a batch,
    and the launches of the member path's counted batches."""
    from neural_ode_metasolver_tpu_torch.attacks import normalize
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.parallel import make_mesh
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, accuracy_ensemble, adversarial_accuracy_ensemble,
        make_ensemble_probs)

    phase(f"ensemble on the member axis: {ENS_MEMBERS} members of "
          f"solver_ensemble_by_noising (RK2 u={U}, {N_STEPS} steps, "
          f"Normal({ENS_SIGMA})), a one-rank mesh beside the member loop, "
          f"clean and FGSM, {ENS_BATCHES} batches of {BATCH}")
    mesh = make_mesh({"ensemble": 1})
    mnist, mdata = ensemble_mnist(torch, dev)
    cifar = build_model("premetanode10", in_planes=64,
                        generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(30)
    cdata = [(normalize(torch.rand(BATCH, 32, 32, 3, generator=g),
                        CIFAR10_MEAN, CIFAR10_STD).to(dev),
              torch.randint(0, 10, (BATCH,), generator=g).to(dev))
             for _ in range(ENS_BATCHES)]
    configs = [
        ("mnist f32", mnist, mdata, None,
         AttackConfig(mode="fgsm", eps=MNIST_FGSM_EPS),
         mnist_forward_counts("standalone", N_STEPS),
         mnist_forward_counts("standalone", N_STEPS)),
        ("premetanode10 bf16", cifar, cdata, torch.bfloat16,
         AttackConfig(mode="fgsm", eps=8 / 255, mean=CIFAR10_MEAN,
                      std=CIFAR10_STD),
         cifar_forward_counts("standalone", N_STEPS),
         cifar_forward_counts("standalone", N_STEPS, b2=False)),
    ]

    def timed(batches, marks):
        for b in batches:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield b
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    record, mesh_counts = {}, Counter()
    for label, model, data, dtype, atk, fwd, atk_fwd in configs:
        members = ensemble_members(torch, model)
        n = len(members)
        # a batch's launches: clean one forward a member; FGSM one attack
        # forward a member (under grad: no B2) with its input's backward,
        # then the clean forward
        clean1 = Counter(fwd)
        fgsm1 = clean1 + Counter(atk_fwd) + Counter({
            "conv3x3_dgrad": atk_fwd.get("conv3x3_same", 0),
            "group_norm_act_bwd": atk_fwd.get("group_norm_act", 0)})
        want = {}
        for what, one in (("clean", clean1), ("fgsm", fgsm1)):
            want[("loop", what)] = {k: n * v for k, v in one.items() if v}
            want[("mesh", what)] = {
                k: v * (1 if k in MEMBER_BATCHED else n)
                for k, v in one.items() if v}
        x0 = data[0][0]
        probs = {}
        for path, m in (("loop", None), ("mesh", mesh)):
            for uk in (True, False):
                fn = make_ensemble_probs(members, mesh=m, compute_dtype=dtype,
                                         use_kernels=uk)
                probs[(path, uk)] = fn(x0).float()
        torch.cuda.synchronize()
        row = {"members": n, "batches": len(data), "batch": BATCH}
        for path, m in (("loop", None), ("mesh", mesh)):
            accuracy_ensemble(members, data[:1], mesh=m,
                              compute_dtype=dtype)  # warm-up
            adversarial_accuracy_ensemble(
                members, data[:1], atk, torch.Generator().manual_seed(0),
                mesh=m, compute_dtype=dtype)
            for what in ("clean", "fgsm"):
                torch.cuda.synchronize()
                port.reset_launch_counts()
                marks = []
                if what == "clean":
                    acc = accuracy_ensemble(members, timed(data, marks),
                                            mesh=m, compute_dtype=dtype)
                else:
                    acc = adversarial_accuracy_ensemble(
                        members, timed(data, marks), atk,
                        torch.Generator().manual_seed(1), mesh=m,
                        compute_dtype=dtype)
                got = port.launch_counts()
                ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
                expect = {k: v * len(data)
                          for k, v in want[(path, what)].items()}
                if got != expect:
                    fail(f"ensemble {label} {path} {what}: launches {got}, "
                         f"expected {expect}")
                if path == "mesh":
                    mesh_counts += Counter(got)
                row[f"{path}_{what}_acc"] = acc
                row[f"{path}_{what}_ms"] = ms
                row[f"{path}_{what}_launches_per_batch"] = want[(path, what)]
        bar = ENS_PROB_BAR[None if dtype is None else "bfloat16"]
        row["probs_mesh_vs_loop"] = (
            probs[("mesh", True)] - probs[("loop", True)]).abs().max().item()
        row["probs_kernel_vs_plain"] = (
            probs[("mesh", True)] - probs[("mesh", False)]).abs().max().item()
        row["probs_plain_mesh_vs_loop"] = (
            probs[("mesh", False)]
            - probs[("loop", False)]).abs().max().item()
        row["probs_bar"] = bar
        record[label] = row
        med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
        print(f"  {label}: probabilities mesh vs loop max|diff| "
              f"{row['probs_mesh_vs_loop']:.3e}, kernel vs plain (mesh) "
              f"{row['probs_kernel_vs_plain']:.3e}, plain mesh vs loop "
              f"{row['probs_plain_mesh_vs_loop']:.3e} (bar {bar:.3e})",
              flush=True)
        print(f"  {label}: accuracy clean mesh {row['mesh_clean_acc']} loop "
              f"{row['loop_clean_acc']}, FGSM mesh {row['mesh_fgsm_acc']} "
              f"loop {row['loop_fgsm_acc']}", flush=True)
        print(f"  {label}: ms a batch (median of {len(data)}) clean mesh "
              f"{med(row['mesh_clean_ms']):.3f} loop "
              f"{med(row['loop_clean_ms']):.3f}, FGSM mesh "
              f"{med(row['mesh_fgsm_ms']):.3f} loop "
              f"{med(row['loop_fgsm_ms']):.3f}; launches a batch clean mesh "
              f"{want[('mesh', 'clean')]} loop {want[('loop', 'clean')]}, "
              f"FGSM mesh {want[('mesh', 'fgsm')]} loop "
              f"{want[('loop', 'fgsm')]}", flush=True)
        if not (row["probs_mesh_vs_loop"] <= bar
                and row["probs_kernel_vs_plain"] <= bar
                and row["probs_plain_mesh_vs_loop"] <= bar):
            fail(f"ensemble {label}: probabilities apart {row}")
    del cifar, cdata
    torch.cuda.empty_cache()
    # phase 30 (d) holds two ranks against this one-rank result
    members = ensemble_members(torch, mnist)
    fn = make_ensemble_probs(members, mesh=mesh)
    record["mnist_probs"] = [fn(x).float().cpu() for x, _ in mdata]
    record["mnist_clean_acc"] = accuracy_ensemble(members, mdata, mesh=mesh)
    del mnist, mdata
    torch.cuda.empty_cache()
    record["counts"] = dict(mesh_counts)
    return record


def run_procs(cmds, timeout=DP_TIMEOUT_S, env=None):
    """Start every command at once (``python3`` with the given arguments,
    from the repo, stdout and stderr captured, ``env`` its environment or
    this one's); wait for all; return [(returncode, stdout, stderr)].  A
    command past ``timeout`` is killed and fails the phase."""
    procs = [subprocess.Popen([sys.executable] + c, cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    except subprocess.TimeoutExpired:
        fail(f"a phase-30 process ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    failed = [f"{' '.join(c[:4])}... exited {rc}: {e.strip()[-1500:]}"
              for c, (rc, o, e) in zip(cmds, out) if rc != 0]
    if failed:
        fail(" | ".join(failed))
    return out


def last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def saved_params(torch, save_dir):
    """The params of ``save_dir``'s newest ``last`` checkpoint, by name."""
    base = os.path.join(save_dir, "last")
    step = sorted(d for d in os.listdir(base) if d.startswith("step_"))[-1]
    return torch.load(os.path.join(base, step, "state"), map_location="cpu",
                      weights_only=True)["params"]


def epoch_losses(save_dir):
    return [r["train_loss"] for r in read_metrics(save_dir)
            if "train_loss" in r]


def dp_phase(port, torch, dev, ens, flagship_ms):
    """Phase 30.  Returns the phase's record."""
    import tempfile

    from neural_ode_metasolver_tpu_torch.models import build_model

    phase(f"data parallelism: (a) one-rank NCCL mnist_runner --mesh data=1 "
          f"vs no mesh, (b) two ranks sharing the card over gloo vs one "
          f"process (dim {MNIST_DIM}, global batch {MNIST_TRAIN_BATCH}), (d) "
          f"phase 29's MNIST ensemble over ensemble=2; then (c) the flagship "
          f"step at batch {BATCH} as two ranks of {BATCH // 2}")
    from neural_ode_metasolver_tpu_torch.data import data_backend

    data_backend("auto")  # the native data library, built before spawning
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_")
    me = os.path.abspath(__file__)
    d = lambda name: os.path.join(tmp, name)  # noqa: E731
    ports = set()
    while len(ports) < 4:
        ports.add(free_port())
    pa, pb1, pb2, pd = sorted(ports)

    def runner(save, extra, train=DP_TRAIN, free=False):
        return [me, "--worker", "runner", json.dumps(
            dp_runner_argv(save, train) + extra)] + (["free"] if free else [])

    def ranks(port, n=2, mesh="data=-1"):
        return [["--mesh", mesh, "--coordinator", f"localhost:{port}",
                 "--num_hosts", str(n), "--process_id", str(r)]
                for r in range(n)]

    cmds = {
        "a_none": runner(d("a_none"), []),
        "a_nccl": runner(d("a_nccl"), ranks(pa, 1, "data=1")[0]),
        "a_free": runner(d("a_free"), [], free=True),
        "b2_one": runner(d("b2_one"), [], DP_HELD_TRAIN),
        "b2_r0": runner(d("b2_two"), ranks(pb1)[0], DP_HELD_TRAIN),
        "b2_r1": runner(d("b2_two"), ranks(pb1)[1], DP_HELD_TRAIN),
        "b_r0": runner(d("b_two"), ranks(pb2)[0]),
        "b_r1": runner(d("b_two"), ranks(pb2)[1]),
        "d_r0": [me, "--worker", "ensemble", str(pd), "0"],
        "d_r1": [me, "--worker", "ensemble", str(pd), "1"],
    }
    t0 = time.perf_counter()
    outs = dict(zip(cmds, run_procs(list(cmds.values()))))
    wall_abd = time.perf_counter() - t0
    res = {k: last_json(o) for k, (_, o, _) in outs.items()}
    record = {"wall_s_abd": wall_abd}

    # (a) one-rank NCCL against no mesh: bit for bit
    la, ln = epoch_losses(d("a_none")), epoch_losses(d("a_nccl"))
    pa_, pn_ = saved_params(torch, d("a_none")), saved_params(torch,
                                                              d("a_nccl"))
    bit = la == ln and all(torch.equal(pa_[k], pn_[k]) for k in pa_)
    record["a"] = {"backend": res["a_nccl"]["backend"], "losses": ln,
                   "losses_no_mesh": la, "bit_equal": bit,
                   "launches": res["a_nccl"]["launches"],
                   "launches_no_mesh": res["a_none"]["launches"],
                   "nccl_all_reduce": res["a_nccl"]["all_reduce"]}
    problems = []
    print(f"  (a) backend {res['a_nccl']['backend']}, one NCCL all-reduce "
          f"{res['a_nccl']['all_reduce']}; losses {ln} vs no mesh {la}; "
          f"params and losses bit-equal: {bit}; launches equal: "
          f"{res['a_nccl']['launches'] == res['a_none']['launches']}",
          flush=True)
    if not bit:
        record["a"]["params_far_share"], record["a"]["params_worst"] = \
            params_apart(pn_, pa_)
        print(f"  (a) params apart: {record['a']['params_far_share']:.3e} "
              f"past 1e-4 max|p|, largest {record['a']['params_worst']:.3e}",
              flush=True)
    if (res["a_nccl"]["backend"] != "nccl" or not bit
            or res["a_nccl"]["all_reduce"] != 1.0
            or res["a_nccl"]["launches"] != res["a_none"]["launches"]):
        problems.append(f"(a): {record['a']}")

    # (b) two ranks over gloo against one process: step 1's loss, then
    # the losses and params after two steps (phase 24's bars); the 20-step
    # runs printed beside the witness
    l2, l2_two = epoch_losses(d("b2_one")), epoch_losses(d("b2_two"))
    far, worst = params_apart(saved_params(torch, d("b2_two")),
                              saved_params(torch, d("b2_one")))
    loss1_rel = abs(l2_two[0] - l2[0]) / abs(l2[0])
    loss2_rel = abs(l2_two[1] - l2[1]) / abs(l2[1])
    ranks_launch = [res["b2_r0"]["launches"], res["b2_r1"]["launches"]]
    lb, lb_two = epoch_losses(d("a_none")), epoch_losses(d("b_two"))
    lw = epoch_losses(d("a_free"))
    p_one = saved_params(torch, d("a_none"))
    far20, worst20 = params_apart(saved_params(torch, d("b_two")), p_one)
    far_w, worst_w = params_apart(saved_params(torch, d("a_free")), p_one)
    rel = lambda a, b: max(abs(x - y) / abs(y)  # noqa: E731
                           for x, y in zip(a, b))
    record["b"] = {"backends": [res["b2_r0"]["backend"],
                                res["b2_r1"]["backend"]],
                   "losses": l2_two, "losses_one": l2,
                   "step1_rel": loss1_rel, "step2_rel": loss2_rel,
                   "params_far_share": far, "params_worst": worst,
                   "launches_per_rank": ranks_launch,
                   "launches_one": res["b2_one"]["launches"],
                   "twenty_steps": {
                       "losses": lb_two, "losses_one": lb,
                       "loss_rel": rel(lb_two, lb),
                       "params_far_share": far20, "params_worst": worst20,
                       "launches_per_rank": [res["b_r0"]["launches"],
                                             res["b_r1"]["launches"]],
                       "witness_losses": lw, "witness_loss_rel": rel(lw, lb),
                       "witness_far_share": far_w,
                       "witness_worst": worst_w},
                   "seconds": [res[k]["seconds"]
                               for k in ("a_none", "b_r0", "b_r1")]}
    tw = record["b"]["twenty_steps"]
    print(f"  (b) backends {record['b']['backends']}; two steps: losses "
          f"{l2_two} vs one process {l2} (step 1 rel {loss1_rel:.3e}, bar "
          f"{FLEET_LOSS1_BAR}; step 2 rel {loss2_rel:.3e}, bar "
          f"{FLEET_LOSS2_BAR}); params more than 1e-4 max|p| apart "
          f"{far:.3e} (bar {FLEET_FAR_SHARE_BAR}), largest {worst:.3e} of "
          f"max|p|; launches a rank {ranks_launch} vs one process "
          f"{res['b2_one']['launches']}", flush=True)
    print(f"  (b) 20 steps (2 epochs of 10): losses {lb_two} vs {lb} (rel "
          f"{tw['loss_rel']:.3e}), params past 1e-4 max|p| {far20:.3e}, "
          f"largest {worst20:.3e}; the witness (one process, cuDNN free "
          f"to use atomics) {lw} (rel {tw['witness_loss_rel']:.3e}), params "
          f"{far_w:.3e}, largest {worst_w:.3e}; runner seconds (one, rank "
          f"0, rank 1, run together with (a) and (d)) "
          f"{record['b']['seconds']}", flush=True)
    if (record["b"]["backends"] != ["gloo", "gloo"]
            or not loss1_rel <= FLEET_LOSS1_BAR
            or not loss2_rel <= FLEET_LOSS2_BAR
            or not far <= FLEET_FAR_SHARE_BAR
            or any(c != res["b2_one"]["launches"] for c in ranks_launch)
            or any(c != res["a_none"]["launches"]
                   for c in tw["launches_per_rank"])):
        problems.append(f"(b): {record['b']}")

    # (d) ensemble=2 over two ranks against phase 29's one rank
    d_err, moved, near = 0.0, 0, 0
    for k in ("d_r0", "d_r1"):
        for p2, p1 in zip(res[k]["probs"], ens["mnist_probs"]):
            p2 = torch.tensor(p2)
            d_err = max(d_err, (p2 - p1).abs().max().item())
            mv, nr = argmax_apart(p2, p1)
            moved, near = moved + mv, max(near, nr)
    record["d"] = {"probs_vs_one_rank": d_err, "bar": ENS_PROB_BAR[None],
                   "clean_acc": [res[k]["clean_acc"]
                                 for k in ("d_r0", "d_r1")],
                   "clean_acc_one_rank": ens["mnist_clean_acc"],
                   "predictions_moved": moved, "near_ties": near,
                   "launches_per_rank": [res[k]["launches"]
                                         for k in ("d_r0", "d_r1")]}
    print(f"  (d) ensemble=2: probabilities vs the one-rank mesh max|diff| "
          f"{d_err:.3e} (bar {ENS_PROB_BAR[None]}), clean accuracy "
          f"{record['d']['clean_acc']} vs {ens['mnist_clean_acc']} "
          f"({near} near-ties), launches a rank "
          f"{record['d']['launches_per_rank']}", flush=True)
    if (not d_err <= ENS_PROB_BAR[None] or moved
            or any(round(abs(a - ens["mnist_clean_acc"]) * BATCH
                         * ENS_BATCHES) > near
                   for a in record["d"]["clean_acc"])):
        problems.append(f"(d): {record['d']}")

    # (c) the flagship step: one process first (f32 gradient, bf16 ms),
    # then two ranks of half the batch each
    model = build_model("premetanode10", in_planes=64,
                        acts=("GeLUpoly",) * 3,
                        generator=torch.Generator().manual_seed(0))
    x, y = flagship_batch(torch, dev)
    g1 = flagship_grad(torch, model, x, y, None)
    single = flagship_timed(torch, port, model, x, y, None)
    torch.save(g1, d("g_one.pt"))
    del model
    torch.cuda.empty_cache()
    pc = free_port()
    t0 = time.perf_counter()
    outs = run_procs([[me, "--worker", "flagship", str(pc), str(r),
                       d(f"g_two{r}.pt")] for r in range(2)])
    wall_c = time.perf_counter() - t0
    rc = [last_json(o) for _, o, _ in outs]
    gmax = max(v.abs().max().item() for v in g1.values())
    gerr = 0.0
    for r in range(2):
        g2 = torch.load(d(f"g_two{r}.pt"), weights_only=True)
        gerr = max(gerr, max((g2[k] - g1[k]).abs().max().item()
                             for k in g1))
    med = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    record["c"] = {"grad_err": gerr, "grad_bar": DP_GRAD_BAR * gmax,
                   "one_process": single, "ranks": rc,
                   "wall_s": wall_c, "phase9_step_ms": flagship_ms}
    print(f"  (c) f32 reduced gradient vs one process max|diff| {gerr:.3e} "
          f"(bar {DP_GRAD_BAR} x max|g| = {DP_GRAD_BAR * gmax:.3e}); bf16 "
          f"ms a step (median of {DP_BF16_STEPS}): one process "
          f"{med(single['ms']):.3f} (phase 9: {flagship_ms:.3f}), rank 0 "
          f"{med(rc[0]['ms']):.3f}, rank 1 {med(rc[1]['ms']):.3f}; the "
          f"all-reduce's ms a step rank 0 "
          f"{[round(m, 3) for m in rc[0]['all_reduce_ms']]}, rank 1 "
          f"{[round(m, 3) for m in rc[1]['all_reduce_ms']]} (gloo, "
          f"{rc[0]['bucket_mb']:.2f} MB a bucket); launches a step a rank "
          f"{[r['launches_per_step'] for r in rc]}", flush=True)
    if not gerr <= DP_GRAD_BAR * gmax:
        problems.append(f"(c): the reduced gradient is {gerr} apart")
    for r in rc:
        if r["launches_per_step"] != TRAIN_PER_STEP or r["backend"] != "gloo":
            problems.append(f"(c): {r}")
    if problems:
        fail("phase 30 " + "; ".join(problems))
    counts = Counter()
    for k in ("a_nccl", "b_r0", "b_r1", "b2_r0", "b2_r1"):
        counts += Counter(res[k]["launches"])
    for r in rc:
        counts += Counter(r["launches"])
    record["counts"] = dict(counts)
    record["ensemble_counts"] = dict(
        Counter(res["d_r0"]["launches"]) + Counter(res["d_r1"]["launches"]))
    import shutil

    shutil.rmtree(tmp, ignore_errors=True)
    return record


def flagship_batch(torch, dev):
    """Phase 9's images and labels at batch 256."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn(BATCH, 32, 32, 3, generator=g).to(dev)
    y = torch.randint(0, 10, (BATCH,), generator=g).to(dev)
    return x, y


def flagship_grad(torch, model, x, y, mesh):
    """One f32 step of phase 9's recipe without the attack (clean, the
    smoothing kept) by SGD at lr 1 from the model's weights: the gradient
    is the params' change.  ``mesh`` makes it data-parallel on this rank's
    rows.  The model's weights are restored after."""
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
    from neural_ode_metasolver_tpu_torch.parallel import (
        batch_sharding, make_parallel_train_step)
    from neural_ode_metasolver_tpu_torch.training import (
        NoiseConfig, create_train_state, make_optimizer, make_train_step)

    snap = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = make_optimizer("sgd", 1.0, momentum=0.0)
    step = make_train_step(model, opt, parse_solver_dsl(
        f"rk2,u,{N_STEPS},-1,{U},-1"), noise_cfg=NoiseConfig(
            noise_type="normal", sigma=0.0125, prob=1.0))
    if mesh is not None:
        step = make_parallel_train_step(step, mesh)
        x, y = batch_sharding(mesh).local((x, y))
    ts = create_train_state(model, opt)
    before = {k: v.detach().clone() for k, v in ts.params.items()}
    step(ts, x, y, torch.Generator().manual_seed(10))
    g = {k: (before[k] - v.detach()).cpu() for k, v in ts.params.items()}
    model.load_state_dict(snap)
    return g


def flagship_timed(torch, port, model, x, y, mesh):
    """Phase 9's bf16 step: a warm-up, then DP_BF16_STEPS timed; with
    ``mesh`` on this rank's rows, the all-reduce timed inside each step
    (synchronized before and after).  Returns ms, all_reduce_ms, losses,
    launches and launches_per_step."""
    from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                     parse_solver_dsl)
    from neural_ode_metasolver_tpu_torch.parallel import (
        batch_sharding, make_parallel_train_step)
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, NoiseConfig, create_train_state, cyclic_lr,
        make_optimizer, make_train_step)
    from neural_ode_metasolver_tpu_torch.training import train as train_mod

    opt = make_optimizer("sgd", cyclic_lr(1e-7, 0.1, 3186), momentum=0.9,
                         weight_decay=5e-4)
    step = make_train_step(
        model, opt, parse_solver_dsl(f"rk2,u,{N_STEPS},-1,{U},-1"),
        SolverOptions(), AttackConfig(mode="fgsm_random", eps=8 / 255,
                                      alpha=10 / 255, mean=CIFAR10_MEAN,
                                      std=CIFAR10_STD),
        NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0),
        compute_dtype=torch.bfloat16)
    ar_ms, bucket = [], []
    if mesh is not None:
        step = make_parallel_train_step(step, mesh)
        x, y = batch_sharding(mesh).local((x, y))
        inner = train_mod.all_reduce_mean

        def timed_all_reduce(tensors, shard):
            tensors = list(tensors)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner(tensors, shard)
            torch.cuda.synchronize()
            ar_ms.append((time.perf_counter() - t0) * 1e3)
            bucket.append(sum(t.numel() for t in tensors) * 4 / 1e6)
            return out

        train_mod.all_reduce_mean = timed_all_reduce
    ts = create_train_state(model, opt)
    gen = torch.Generator().manual_seed(10)
    ts, m = step(ts, x, y, gen)  # warm-up
    torch.cuda.synchronize()
    ar_ms.clear()
    port.reset_launch_counts()
    ms, losses = [], []
    for _ in range(DP_BF16_STEPS):
        t0 = time.perf_counter()
        ts, m = step(ts, x, y, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(m["loss"].item())
    counts = port.launch_counts()
    if mesh is not None:
        train_mod.all_reduce_mean = inner
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 30 (c): non-finite losses {losses}")
    return {"ms": ms, "all_reduce_ms": ar_ms, "losses": losses,
            "bucket_mb": bucket[0] if bucket else 0.0,
            "launches": counts,
            "launches_per_step": {k: v // DP_BF16_STEPS
                                  for k, v in counts.items()}}


# Phase 31: the flagship recipe over a model, sp or pp axis of two gloo
# ranks sharing the card, against one process.  Every rank computes with
# the global batch (data=1).  The B1, dgrad and wgrad shapes those axes
# give the kernels (phases 3-4 hold and time them): tp the local output
# channels (Cout / 2), sp this rank's rows plus a halo row each side
# (H / 2 + 2), pp a microbatch (M = 2, 4) of the pipelined ODE stacks.
TP_STEM, TP_L1, TP_L2 = ((BATCH, 32, 32, 3, 32), (BATCH, 32, 32, 64, 32),
                         (BATCH, 16, 16, 128, 64))
SP_STEM, SP_L1, SP_L2 = ((BATCH, 18, 32, 3, 64), (BATCH, 18, 32, 64, 64),
                         (BATCH, 10, 16, 128, 128))
PP_MICROBATCHES = (2, 4)
PP_BLOCKS = ((1, 2), (1, 2))
PP_BATCH = BATCH
PP_SHAPES = [(PP_BATCH // m, h, h, c, c) for m in PP_MICROBATCHES
             for h, c in ((32, 64), (16, 128))]
MESH_SHAPES = [TP_STEM, TP_L1, TP_L2, SP_STEM, SP_L1, SP_L2] + PP_SHAPES
MESH_AXES = {"tp": "model", "sp": "sp", "pp": "pp"}
MESH_F32_STEPS = 2  # held against one process (phase 24's bars)
# one timed bf16 step, after a warm-up but on tp's ranks, whose step (the
# seam's collectives through the host) takes seconds either way
MESH_BF16_STEPS = 1
MESH_EVAL_BATCH = 64  # the no-grad eval checks
MESH_SWITCH_BAR = 1e-6
MESH_TIMEOUT_S = 600


def mesh_per_step(kind, m=None):
    """Launches a rank makes in one flagship-recipe step (pp's at
    PP_BATCH: the counts do not depend on the batch).  A pass runs B1
    for the stem, the three stride-1 res convs and 32 a block (8 RK2 steps
    x 2 stages x 2 convs); tp and sp keep phase 9's count (on local
    channels or rows); under pp a rank runs its stage's block of each of
    the two layers once a microbatch, so 64 x M a pass.  The dgrad runs
    for every conv of both passes but the stem's in the training pass, the
    wgrad for every conv of the training pass."""
    if kind in ("tp", "sp"):
        return dict(TRAIN_PER_STEP)
    ode = 64 * m
    # GeLUpoly: the stem's and the res blocks' 5, and two an RHS call, as
    # its convs; every call differentiated in both passes
    return {"conv3x3_same": 2 * (4 + ode), "conv3x3_dgrad": 1 + 2 * (3 + ode),
            "conv3x3_wgrad": 4 + ode, "gelu_poly": 2 * (5 + ode),
            "gelu_poly_bwd": 2 * (5 + ode)}


def mesh_model(torch, kind, acts=("GeLUpoly",) * 3, pipeline=None):
    from neural_ode_metasolver_tpu_torch.models import (MODEL_REGISTRY,
                                                        make_cifar_model)

    cfg = MODEL_REGISTRY["premetanode10"](
        in_planes=64, acts=acts,
        num_blocks=PP_BLOCKS if kind == "pp" else ((1, 1),) * 2)
    return make_cifar_model(cfg, pipeline=pipeline,
                            generator=torch.Generator().manual_seed(0))


def mesh_step(torch, model, mesh, kind, compute_dtype, ts=None):
    """The flagship recipe's step (phase 30's) on ``model``, over ``mesh``'s
    axis for ``kind`` when given; returns (state, step)."""
    from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                     parse_solver_dsl)
    from neural_ode_metasolver_tpu_torch.parallel import (
        make_parallel_train_step)
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig, NoiseConfig, create_train_state, cyclic_lr,
        make_optimizer, make_train_step)

    opt = make_optimizer("sgd", cyclic_lr(1e-7, 0.1, 3186), momentum=0.9,
                         weight_decay=5e-4)
    step = make_train_step(
        model, opt, parse_solver_dsl(f"rk2,u,{N_STEPS},-1,{U},-1"),
        SolverOptions(), AttackConfig(mode="fgsm_random", eps=8 / 255,
                                      alpha=10 / 255, mean=CIFAR10_MEAN,
                                      std=CIFAR10_STD),
        NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0),
        compute_dtype=compute_dtype)
    ts = create_train_state(model, opt)
    if mesh is not None:
        step = make_parallel_train_step(
            step, mesh, ts, model_axis="model" if kind == "tp" else None,
            spatial_axis="sp" if kind == "sp" else None)
    return ts, step


def mesh_run(torch, port, dev, kind, mesh=None, m=None):
    """One process (``mesh`` None) or one rank of ``kind``: MESH_F32_STEPS
    f32 steps from the seed-0 weights (cuDNN deterministic): their losses,
    the global params after them and the launches a step; then
    MESH_BF16_STEPS timed bf16 steps (cuDNN's defaults)."""
    from neural_ode_metasolver_tpu_torch.parallel import PipelineConfig
    from neural_ode_metasolver_tpu_torch.parallel.mesh import tp_sharding_of

    pipe = (PipelineConfig(mesh=mesh, axis="pp", n_microbatches=m,
                           batch_axis="data")
            if mesh is not None and kind == "pp" else None)
    model = mesh_model(torch, kind, pipeline=pipe)
    x, y = flagship_batch(torch, dev)
    if kind == "pp":
        x, y = x[:PP_BATCH], y[:PP_BATCH]
    gen = torch.Generator().manual_seed(10)
    torch.cuda.reset_peak_memory_stats(dev)
    with deterministic_cudnn(torch):
        ts, step = mesh_step(torch, model, mesh, kind, None)
        port.reset_launch_counts()
        losses = []
        for _ in range(MESH_F32_STEPS):
            ts, met = step(ts, x, y, gen)
            losses.append(met["loss"].item())
        torch.cuda.synchronize()
        counts = port.launch_counts()
    params = {}
    for k, v in ts.params.items():
        rule = tp_sharding_of(v)
        params[k] = (v if rule is None else rule.gather(v)).detach().cpu()
    ts, step = mesh_step(torch, model, mesh, kind, torch.bfloat16)
    if mesh is None or kind != "tp":
        ts, _ = step(ts, x, y, gen)  # warm-up
    torch.cuda.synchronize()
    ms = []
    for _ in range(MESH_BF16_STEPS):
        t0 = time.perf_counter()
        ts, _ = step(ts, x, y, gen)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    peak_reserved = torch.cuda.max_memory_reserved(dev) / 2 ** 30
    del model, ts, step
    torch.cuda.empty_cache()
    if not all(math.isfinite(v) for v in losses):
        fail(f"phase 31 {kind}: non-finite losses {losses}")
    return {"losses": losses, "launches": counts, "bf16_ms": ms,
            "peak_gib": peak, "peak_reserved_gib": peak_reserved,
            "launches_per_step": {k: v // MESH_F32_STEPS
                                  for k, v in counts.items()}}, params


def mesh_pp_evals(torch, port, dev, mesh):
    """pp's no-grad checks at MESH_EVAL_BATCH, M = 2, f32: the switch
    regime's logits against the sequential model's (the draws made in the
    sequential loop's order), and the exact-GELU NF stack, whose no-grad
    forward runs B2 once a microbatch for this rank's block of each layer,
    against the sequential model's (B2 once a block on the batch)."""
    from neural_ode_metasolver_tpu_torch.ops import (SolverOptions,
                                                     create_solver)
    from neural_ode_metasolver_tpu_torch.parallel import PipelineConfig

    x = flagship_batch(torch, dev)[0][:MESH_EVAL_BATCH]  # M = 2 of 32
    pcfg = PipelineConfig(mesh=mesh, axis="pp", n_microbatches=2,
                          batch_axis="data")
    out = {}
    two = [create_solver("rk2", "u", n_steps=N_STEPS, u0=u)
           for u in (0.5, 1.0)]
    sw = SolverOptions(solver_mode="switch")
    for name, acts, solvers, opts in (
            ("switch", ("GeLUpoly",) * 3, two, sw),
            ("b2", ("GeLU",) * 3, two[:1], SolverOptions())):
        seq = mesh_model(torch, "pp", acts)
        pp = mesh_model(torch, "pp", acts, pcfg)
        err, counts = 0.0, []
        for trial in range(3 if name == "switch" else 1):
            g = lambda: torch.Generator().manual_seed(100 + trial)  # noqa
            with torch.no_grad():
                port.reset_launch_counts()
                a = seq(x, solvers, opts, generator=g())
                torch.cuda.synchronize()
                c_seq = port.launch_counts()
                port.reset_launch_counts()
                b = pp(x, solvers, opts, generator=g())
                torch.cuda.synchronize()
                counts.append((c_seq, port.launch_counts()))
            err = max(err, (a - b).abs().max().item())
        out[name] = {"max_abs_err": err, "launches": counts[-1][1],
                     "launches_sequential": counts[-1][0]}
        del seq, pp
    return out


def mesh_b2_eval(torch, port, dev, mesh, kind):
    """tp's or sp's no-grad check at MESH_EVAL_BATCH, f32: the exact-GELU
    NF flagship on this rank's output channels (tp) or rows (sp), whose
    ODE blocks run B2 on the gathered kernels (tp) or on the gathered rows
    (sp), against the unsharded model on B2."""
    from neural_ode_metasolver_tpu_torch.ops import parse_solver_dsl
    from neural_ode_metasolver_tpu_torch.parallel import shard_params_tp
    from neural_ode_metasolver_tpu_torch.parallel.mesh import (
        shard_state_tp, spatial_rows)
    from neural_ode_metasolver_tpu_torch.training import (
        create_train_state, make_optimizer)

    x = flagship_batch(torch, dev)[0][:MESH_EVAL_BATCH]
    solvers = parse_solver_dsl(f"rk2,u,{N_STEPS},-1,{U},-1")
    whole = mesh_model(torch, kind, ("GeLU",) * 3)
    part = mesh_model(torch, kind, ("GeLU",) * 3)
    sp, xp = None, x
    if kind == "tp":
        ts = create_train_state(part, make_optimizer("sgd", 0.0))
        shard_state_tp(ts, shard_params_tp(ts.params, mesh, "model"))
    else:
        sp = mesh.shard("sp")
        xp = x[:, sp.rows(x.shape[1])]
    with torch.no_grad():
        port.reset_launch_counts()
        a = whole(x, solvers)
        torch.cuda.synchronize()
        c_whole = port.launch_counts()
        port.reset_launch_counts()
        with spatial_rows(sp):
            b = part(xp, solvers)
        torch.cuda.synchronize()
    return {"max_abs_err": (a - b).abs().max().item(),
            "logit_max": a.abs().max().item(),
            "launches": port.launch_counts(), "launches_whole": c_whole}


def mesh_worker(port_, rank, out_path):
    """A rank of phase 31's tp, sp and pp parts, run in turn in one process
    group: prints one JSON line."""
    import torch

    import neural_ode_metasolver_tpu_torch as port
    from neural_ode_metasolver_tpu_torch.parallel import (
        initialize_distributed, make_mesh)

    dev = initialize_distributed(f"localhost:{port_}", 2, rank)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    out, params = {}, {}
    for kind, axis in MESH_AXES.items():
        t0 = time.perf_counter()
        mesh = make_mesh({"data": 1, axis: 2})
        rec, params[kind] = {}, {}
        for m in (PP_MICROBATCHES if kind == "pp" else (None,)):
            rec[str(m)], params[kind][str(m)] = mesh_run(torch, port, dev,
                                                         kind, mesh, m)
        if kind == "pp":
            rec["evals"] = mesh_pp_evals(torch, port, dev, mesh)
        else:
            rec["eval"] = mesh_b2_eval(torch, port, dev, mesh, kind)
        torch.cuda.empty_cache()
        rec["wall_s"] = time.perf_counter() - t0
        out[kind] = rec
    if rank == 0:
        torch.save(params, out_path)
    out["backend"] = torch.distributed.get_backend()
    torch.distributed.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def mesh_cli_argv(save_dir):
    """cifar_runner's flags for phase 31 (d): the flagship recipe on a
    narrower net (in_planes 16) with pipelined stacks, one short epoch
    of synthetic images (one step: the CLI's path, not its speed)."""
    return ["--network", "premetanode10", "--num_blocks", "1,2;1,2",
            "--in_planes", "16",
            "--solvers", f"rk2,u,{N_STEPS},-1,{U},-1", "--nepochs", "1",
            "--batch_size", "64", "--test_batch_size", "64",
            "--synthetic_train_size", "80", "--synthetic_test_size", "64",
            "--adv_training_mode", "fgsm_random", "--noise_type", "normal",
            "--noise_sigma", "0.0125", "--noise_prob", "1.0", "--precision",
            "bf16", "--prefetch", "0", "--save_dir", save_dir]


def mesh_axes_phase(port, torch, dev):
    """Phase 31.  Returns the phase's record."""
    import shutil
    import tempfile

    phase(f"tensor, spatial and pipeline parallelism: the flagship recipe "
          f"(batch {BATCH}) over (a) data=1,model=2, (b) data=1,sp=2 and "
          f"(c) data=1,pp=2 with num_blocks {PP_BLOCKS} at M = "
          f"{PP_MICROBATCHES} (batch {PP_BATCH}), as two gloo ranks sharing "
          f"the card (one process group, the parts in turn), against one "
          f"process: {MESH_F32_STEPS} f32 steps held, a bf16 step timed, "
          f"launches a rank exact; (a), (b) also a no-grad exact-GELU eval "
          f"on B2 (the kernels, the rows gathered); (c) also the switch "
          f"regime's logits and a no-grad exact-GELU eval on B2; (d) "
          f"cifar_runner --mesh data=1,pp=2, one epoch, then a resume")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    me = os.path.abspath(__file__)
    record, problems = {}, []
    ones = {}
    for kind in ("tp", "pp"):  # sp's one process is tp's: the flagship
        ones[kind], ones[kind + "_params"] = mesh_run(
            torch, port, dev, kind, None, 1)
    ones["sp"], ones["sp_params"] = ones["tp"], ones["tp_params"]
    torch.cuda.empty_cache()
    record["parent_reserved_gib"] = torch.cuda.memory_reserved(dev) / 2 ** 30
    record["card_free_gib"] = torch.cuda.mem_get_info(dev)[0] / 2 ** 30
    t0 = time.perf_counter()
    pt = free_port()
    # a pp rank of the four-block net at batch 256 holds about 36 GiB: two
    # of them fill the card unless their allocators map memory in
    # expandable segments (without them each kept some 2.5 GiB of free
    # fragments, and a rank ran out of memory at 35.2 GiB allocated)
    outs = run_procs([[me, "--worker", "mesh", str(pt), str(r),
                       os.path.join(tmp, "mesh.pt")] for r in range(2)],
                     timeout=MESH_TIMEOUT_S, env=dict(
                         os.environ,
                         PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True"))
    ranks = [last_json(o) for _, o, _ in outs]
    record["ranks_wall_s"] = time.perf_counter() - t0
    params = torch.load(os.path.join(tmp, "mesh.pt"), weights_only=True)
    want_b2 = {"conv3x3_same": 4, "ode_block_rk2": 2 * B2_LAUNCHES_PER_SOLVE}
    for kind in MESH_AXES:
        one, p_one = ones[kind], ones[kind + "_params"]
        rec = {"wall_s": ranks[0][kind]["wall_s"],
               "backends": [r["backend"] for r in ranks],
               "one_process": {k: one[k] for k in (
                   "losses", "bf16_ms", "launches_per_step", "peak_gib")}}
        for m in (PP_MICROBATCHES if kind == "pp" else (None,)):
            got = [r[kind][str(m)] for r in ranks]
            want = mesh_per_step(kind, m)
            far, worst = params_apart(params[kind][str(m)], p_one)
            l1 = abs(got[0]["losses"][0] - one["losses"][0]) \
                / abs(one["losses"][0])
            l2 = abs(got[0]["losses"][1] - one["losses"][1]) \
                / abs(one["losses"][1])
            sub = {"losses": got[0]["losses"], "step1_rel": l1,
                   "step2_rel": l2, "params_far_share": far,
                   "params_worst": worst,
                   "launches_per_step_per_rank": [g["launches_per_step"]
                                                  for g in got],
                   "expected_per_step": want,
                   "bf16_ms_per_rank": [g["bf16_ms"] for g in got],
                   "peak_gib_per_rank": [g["peak_gib"] for g in got],
                   "peak_reserved_gib_per_rank": [g["peak_reserved_gib"]
                                                  for g in got],
                   "launches": [g["launches"] for g in got]}
            rec[f"M={m}" if m else "step"] = sub
            print(f"  ({kind}{'' if m is None else f', M={m}'}) losses "
                  f"{sub['losses']} vs one process {one['losses']} (step 1 "
                  f"rel {l1:.3e}, bar {FLEET_LOSS1_BAR}; step 2 rel "
                  f"{l2:.3e}, bar {FLEET_LOSS2_BAR}); params past 1e-4 "
                  f"max|p| {far:.3e} (bar {FLEET_FAR_SHARE_BAR}), largest "
                  f"{worst:.3e}; launches a step a rank "
                  f"{sub['launches_per_step_per_rank']} (expected {want}); "
                  f"bf16 step ms a rank {sub['bf16_ms_per_rank']} vs one "
                  f"process {one['bf16_ms']}; peak GiB a rank "
                  f"{[round(v, 2) for v in sub['peak_gib_per_rank']]} "
                  f"(reserved "
                  f"{[round(v, 2) for v in sub['peak_reserved_gib_per_rank']]}"
                  f") vs {one['peak_gib']:.2f}", flush=True)
            if (not l1 <= FLEET_LOSS1_BAR or not l2 <= FLEET_LOSS2_BAR
                    or not far <= FLEET_FAR_SHARE_BAR
                    or any(g["launches_per_step"] != want for g in got)
                    or any(v % MESH_F32_STEPS for g in got
                           for v in g["launches"].values())):
                problems.append(f"({kind}, M={m}): {sub}")
        if kind == "pp":
            ev = [r["pp"]["evals"] for r in ranks]
            m2 = 2 * 2 * B2_LAUNCHES_PER_SOLVE  # 2 layers x M=2
            want_pp = {"conv3x3_same": 4, "ode_block_rk2": m2}
            rec["evals"] = ev
            print(f"  (pp) switch logits vs sequential max|diff| "
                  f"{[e['switch']['max_abs_err'] for e in ev]} (bar "
                  f"{MESH_SWITCH_BAR}); exact-GELU eval on B2: logits "
                  f"{[e['b2']['max_abs_err'] for e in ev]}, launches a rank "
                  f"{[e['b2']['launches'] for e in ev]} (expected "
                  f"{want_pp}; sequential "
                  f"{ev[0]['b2']['launches_sequential']})", flush=True)
            for e in ev:
                if (not e["switch"]["max_abs_err"] <= MESH_SWITCH_BAR
                        or not e["b2"]["max_abs_err"] <= MESH_SWITCH_BAR
                        or e["b2"]["launches"] != want_pp):
                    problems.append(f"(pp evals): {e}")
        else:
            ev = [r[kind]["eval"] for r in ranks]
            bar = 1e-4 * max(1.0, ev[0]["logit_max"])
            rec["eval"] = ev
            print(f"  ({kind}) no-grad exact-GELU eval on B2 ("
                  f"{'kernels' if kind == 'tp' else 'rows'} gathered): "
                  f"logits vs the unsharded model max|diff| "
                  f"{[e['max_abs_err'] for e in ev]} (bar {bar:.3e}); "
                  f"launches a rank {[e['launches'] for e in ev]} (expected "
                  f"{want_b2}; unsharded {ev[0]['launches_whole']})",
                  flush=True)
            for e in ev:
                if (not e["max_abs_err"] <= bar or e["launches"] != want_b2
                        or e["launches_whole"] != want_b2):
                    problems.append(f"({kind} eval): {e}")
        if rec["backends"] != ["gloo", "gloo"]:
            problems.append(f"({kind}): backends {rec['backends']}")
        print(f"  ({kind}) {rec['wall_s']:.1f} s in the ranks", flush=True)
        record[kind] = rec
    print(f"  ranks' process {record['ranks_wall_s']:.1f} s; the parent "
          f"held {record['parent_reserved_gib']:.2f} GiB while they ran, "
          f"the card had {record['card_free_gib']:.2f} GiB free as they "
          f"started", flush=True)
    # (d) the CLI: one epoch over pp=2, then a resume for one more, in
    # one process a rank (a process group for each run)
    save = os.path.join(tmp, "cli")
    t0 = time.perf_counter()
    pts = [free_port(), free_port()]
    while pts[1] == pts[0]:
        pts[1] = free_port()
    runs = [[mesh_cli_argv(save) + extra + [
        "--mesh", "data=1,pp=2", "--coordinator", f"localhost:{p}",
        "--num_hosts", "2", "--process_id", str(r)]
        for extra, p in (([], pts[0]), (["--resume"], pts[1]))]
        for r in range(2)]
    outs = run_procs([[me, "--worker", "runner_cifar", json.dumps(a)]
                      for a in runs], timeout=MESH_TIMEOUT_S)
    cli = [last_json(o)["runs"] for _, o, _ in outs]
    steps = sorted(os.listdir(os.path.join(save, "last")))
    losses = epoch_losses(save)
    record["d"] = {"checkpoints": steps, "losses": losses,
                   "launches": [run["launches"] for r in cli for run in r],
                   "wall_s": time.perf_counter() - t0}
    print(f"  (d) cifar_runner --mesh data=1,pp=2: checkpoints {steps}, "
          f"epoch losses {losses} ({record['d']['wall_s']:.1f} s)",
          flush=True)
    if len(steps) != 2 or len(losses) != 2 or not all(
            math.isfinite(v) for v in losses):
        problems.append(f"(d): {record['d']}")
    shutil.rmtree(tmp, ignore_errors=True)
    if problems:
        fail("phase 31 " + "; ".join(problems))
    counts = {}
    for kind in MESH_AXES:
        c = Counter()
        for key, sub in record[kind].items():
            if key == "step" or key.startswith("M="):
                for cnt in sub["launches"]:
                    c += Counter(cnt)
        if kind == "pp":
            for e in record["pp"]["evals"]:
                c += Counter(e["b2"]["launches"])
            for cnt in record["d"]["launches"]:
                c += Counter(cnt)
        else:
            for e in record[kind]["eval"]:
                c += Counter(e["launches"])
        counts[kind] = dict(c)
    record["counts"] = counts
    record["wall_s"] = time.perf_counter() - t_phase
    return record


def worker(argv):
    """Phase 30's subprocesses: ``runner ARGV_JSON`` runs mnist_runner
    (forming its process group from the flags) and prints its launches
    and backend; ``ensemble PORT RANK`` runs phase 29's MNIST ensemble
    over an ensemble axis of two gloo ranks; ``flagship PORT RANK OUT``
    one f32 gradient and the timed bf16 steps of phase 9's recipe on
    this rank's half of the batch; phase 31's: ``mesh PORT RANK OUT`` a
    rank of its tp, sp and pp parts, ``runner_cifar ARGV_JSON``
    cifar_runner as ``runner`` runs mnist_runner (ARGV_JSON a list of
    runs makes them in turn).  Each prints one JSON line."""
    import torch

    sys.path.insert(0, REPO)
    import neural_ode_metasolver_tpu_torch as port
    from neural_ode_metasolver_tpu_torch.parallel import (
        initialize_distributed, make_mesh)

    dist = torch.distributed
    kind = argv[0]
    if kind == "mesh":
        return mesh_worker(int(argv[1]), int(argv[2]), argv[3])
    if kind in ("runner", "runner_cifar"):
        from neural_ode_metasolver_tpu_torch.runners import (cifar_runner,
                                                             mnist_runner)
        runner = cifar_runner if kind == "runner_cifar" else mnist_runner

        # cuDNN's stem and strided convs are the step's only kernels that
        # may order their sums by atomics: pick its deterministic
        # algorithms, so two runs of one program can agree bit for bit
        # (``free``: the witness, cuDNN's defaults)
        torch.backends.cudnn.deterministic = argv[2:3] != ["free"]
        torch.backends.cudnn.benchmark = False
        # ARGV_JSON: one run's flags, or a list of runs made in turn (a
        # process group for each), which print {"runs": [...]}
        argvs = json.loads(argv[1])
        single = bool(argvs) and isinstance(argvs[0], str)
        runs = [argvs] if single else argvs
        outs = []
        for a in runs:
            port.reset_launch_counts()
            t0 = time.perf_counter()
            runner.main(a)
            torch.cuda.synchronize()
            out = {"launches": port.launch_counts(),
                   "seconds": time.perf_counter() - t0,
                   "backend": dist.get_backend() if dist.is_initialized()
                   else None, "all_reduce": None}
            if dist.is_initialized():
                one = torch.ones(1, device="cuda")
                dist.all_reduce(one)
                out["all_reduce"] = one.item() / dist.get_world_size()
                dist.destroy_process_group()
            outs.append(out)
        print(json.dumps(outs[0] if single else {"runs": outs}), flush=True)
        return 0
    port_, rank = int(argv[1]), int(argv[2])
    dev = initialize_distributed(f"localhost:{port_}", 2, rank)
    if kind == "ensemble":
        from neural_ode_metasolver_tpu_torch.training import (
            accuracy_ensemble, make_ensemble_probs)

        mesh = make_mesh({"ensemble": 2})
        model, data = ensemble_mnist(torch, dev)
        members = ensemble_members(torch, model)
        port.reset_launch_counts()
        fn = make_ensemble_probs(members, mesh=mesh)
        probs = [fn(x).float().cpu().tolist() for x, _ in data]
        acc = accuracy_ensemble(members, data, mesh=mesh)
        torch.cuda.synchronize()
        out = {"probs": probs, "clean_acc": acc,
               "launches": port.launch_counts()}
    else:
        from neural_ode_metasolver_tpu_torch.models import build_model

        mesh = make_mesh({"data": 2})
        model = build_model("premetanode10", in_planes=64,
                            acts=("GeLUpoly",) * 3,
                            generator=torch.Generator().manual_seed(0))
        x, y = flagship_batch(torch, dev)
        torch.save(flagship_grad(torch, model, x, y, mesh), argv[3])
        out = flagship_timed(torch, port, model, x, y, mesh)
    out["backend"] = dist.get_backend()
    dist.destroy_process_group()
    print(json.dumps(out), flush=True)
    return 0


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA device")
    sys.path.insert(0, REPO)
    try:
        import neural_ode_metasolver_tpu_torch as port
    except ImportError as e:
        fail(f"the port package is not beside this script: {e}")
    if not os.path.abspath(port.__file__).startswith(REPO + os.sep):
        fail(f"imported the port from {port.__file__}, not from {REPO}")
    from neural_ode_metasolver_tpu_torch import _build
    from neural_ode_metasolver_tpu_torch.models import build_model
    from neural_ode_metasolver_tpu_torch.ops import (
        SolverOptions,
        parse_solver_dsl,
    )
    from neural_ode_metasolver_tpu_torch.attacks import cross_entropy
    from neural_ode_metasolver_tpu_torch.backend import full_f32
    from neural_ode_metasolver_tpu_torch.ops.conv3x3 import (
        conv3x3_dgrad,
        conv3x3_f32_plan,
        conv3x3_path,
        conv3x3_same,
        conv3x3_wgrad,
        flip_weights,
        reference_conv3x3,
        reference_conv3x3_wgrad,
        wgrad_plan,
    )
    from neural_ode_metasolver_tpu_torch.ops.group_norm import (
        fused_group_norm_act,
        group_norm_backward,
        group_norm_backward_reference,
        group_norm_reference,
        launch_plan,
    )
    from neural_ode_metasolver_tpu_torch.ops.ode_block import (
        ode_block_rk2_forward,
        reference_ode_block_rk2,
    )
    from neural_ode_metasolver_tpu_torch.serving import ServedModel
    from neural_ode_metasolver_tpu_torch.attacks import normalize, pgd
    from neural_ode_metasolver_tpu_torch.ops import create_solver
    from neural_ode_metasolver_tpu_torch.training import (
        AttackConfig,
        NoiseConfig,
        accuracy,
        accuracy_ensemble,
        adversarial_accuracy,
        adversarial_accuracy_ensemble,
        create_train_state,
        make_adversarial_predict,
        make_ensemble_attacked_probs,
        make_ensemble_probs,
        make_eval_step,
        make_optimizer,
        make_train_step,
        notebook_regime_grid,
        sn_test,
    )

    # the kernel phases hold f32 kernels against plain versions that run on
    # cuDNN, so TF32 is off there; the serving phases run with the process
    # defaults (cuDNN may take TF32), which the model overrides itself
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    tf32_defaults = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    dev = torch.device("cuda")

    # ------------------------------------------------------------ 1 device
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = " | ".join(l.strip() for l in smi.stdout.splitlines() if l.strip())
    print(f"device: {kind}; nvidia-smi: {card}", flush=True)

    # ------------------------------------------------------------- 2 build
    phase("build")
    t0 = time.perf_counter()
    per_lib = _build.build_all()
    build_s = time.perf_counter() - t0
    print(f"built {sorted(per_lib)} in {build_s:.2f} s (parallel nvcc)",
          flush=True)
    for name in per_lib:
        for line in _build.build_log(name).splitlines():
            if "warning" in line:
                print(f"  ptxas[{name}]: {line.strip()}")
        lines = [l.strip() for l in _build.build_log(name).splitlines()
                 if "registers" in l or "spill" in l]
        if len(lines) <= 24:
            for line in lines:
                print(f"  ptxas[{name}]: {line}")
            continue
        # many template instances (B3): one summary line
        regs = [int(l.split("Used ")[1].split()[0]) for l in lines
                if "Used " in l]
        spills = [int(l.split(" bytes spill stores")[0].split()[-1])
                  for l in lines if "bytes spill stores" in l]
        print(f"  ptxas[{name}]: {len(regs)} kernels, {min(regs)}-"
              f"{max(regs)} registers, {sum(1 for v in spills if v)} with "
              f"spill stores (at most {max(spills)} bytes)")
    # B3's backward spills nowhere (its staged instances run two blocks an
    # SM within 128 registers a thread)
    spilled = [c.split("'")[1] for c in _build.build_log(
        "group_norm_act_bwd").split("Compiling entry function")[1:]
        if re.search(r"[1-9][0-9]* bytes spill stores", c)]
    if spilled:
        fail(f"group_norm_act_bwd: ptxas spills in {spilled}")
    for name in per_lib:
        mma = _build.sass_opcode_counts(name, ("HMMA", "HGMMA"))
        print(f"  SASS[{name}]: {mma['HMMA']} HMMA, {mma['HGMMA']} HGMMA "
              f"(tensor-core instructions)", flush=True)
        if name in ("conv3x3", "ode_block_rk2") and not sum(mma.values()):
            fail(f"the {name} library has no tensor-core instruction")
        if name == "conv3x3_wgrad" and not mma["HGMMA"]:
            fail("the wgrad library has no HGMMA: its TMA path needs wgmma")
    # every f32 conv, dgrad and wgrad runs the f32 kernels; the old f32 FMA
    # instances (float ones of the bf16 gather and split-K kernels) are gone
    for name, new, old in (("conv3x3", "conv3x3_f32_kernel",
                            "conv3x3_igemm_kernelIf"),
                           ("ode_block_rk2", "conv3x3_f32_kernel",
                            "conv3x3_igemm_kernelIf"),
                           ("conv3x3_wgrad", "wgrad_f32_kernel",
                            "wgrad_partial_kernelIf")):
        names = _build.kernel_names(name)
        n_new = sum(new in k for k in names)
        print(f"  kernels[{name}]: {len(names)}, {n_new} of {new}",
              flush=True)
        if not n_new or any(old in k for k in names):
            fail(f"the {name} library lacks {new} or holds {old}*")

    gen = torch.Generator(device=dev)

    def randn(shape, scale, seed, dtype):
        gen.manual_seed(seed)
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(
            dtype)

    def time_ms(fn, reps):
        """Device ms per call: ``reps`` calls captured in one CUDA graph and
        timed with CUDA events around its replay.  Issued one by one, a
        call at the MNIST ODE block's shapes costs the host more than the
        card (Python wrapper, ctypes), so events around a loop of calls
        would time the host."""
        fn()  # warm-up outside the capture: build, load, cuDNN plans
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        del graph
        return start.elapsed_time(end) / reps

    def bound(nbytes, flops, dtype):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS[str(dtype).split(".")[-1]] * 1e3
        return max(t_bytes, t_ops), t_bytes, t_ops

    def rate(flops, ms, bound_ms):
        """Achieved TFLOP/s and the share of the bound reached."""
        return {"tflops": flops / (ms * 1e-3) / 1e12,
                "bound_share": bound_ms / ms}

    dtypes = [torch.float32, torch.bfloat16]

    # ----------------------------------------------------- 3 B1 vs plain
    phase("B1 conv3x3_same vs its plain version (batch 256; f32 also the "
          "digits step's ConcatConv2d at batch 128; phase 31's tp, sp and "
          "pp shapes)")
    b1_rows = []
    b1_shapes = [c[1:6] for c in B1_CALLS + B1_MNIST_CALLS] + MESH_SHAPES
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def f32_plan(n, h, w, cin, cout):
        """The f32 core's plan, checked against the path the launcher
        takes for it; printable."""
        plan = conv3x3_f32_plan(n, h, w, cin, cout, sms)
        path = conv3x3_path(n, h, w, cin, cout, torch.float32, dev)
        if path != plan.path:
            fail(f"f32 {(n, h, w, cin, cout)}: the launcher takes {path}, "
                 f"the plan {plan.path}")
        return (f"{plan.path} (rows {plan.rows}, cols {plan.cols}, K in "
                f"{plan.ksplit}, {plan.stages} ring slots)")

    for dtype in dtypes:
        for shape in dict.fromkeys(b1_shapes + (
                [TRAIN_MNIST] if dtype == torch.float32 else [])):
            n, h, w, cin, cout = shape
            x = randn((n, h, w, cin), 1.0, 1, dtype)
            k = randn((3, 3, cin, cout), (9 * cin) ** -0.5, 2, dtype)
            got = conv3x3_same(x, k)
            torch.cuda.synchronize()
            ref = reference_conv3x3(x, k)
            err = (got.float() - ref.float()).abs().max().item()
            refmax = ref.float().abs().max().item()
            # f32: sum order only; bf16: one output rounding may flip, one
            # bf16 ulp of the largest output
            bar = (1e-4 * max(1.0, refmax) if dtype == torch.float32
                   else 2.0 ** -7 * refmax)
            ms = time_ms(lambda: conv3x3_same(x, k), 20)
            plain_ms = time_ms(lambda: reference_conv3x3(x, k), 20)
            x_cl = x.permute(0, 3, 1, 2)  # NCHW view, channels_last strides
            k_cl = k.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib_ms = time_ms(
                lambda: torch.nn.functional.conv2d(x_cl, k_cl, padding=1), 20)
            es = x.element_size()
            nbytes = (x.numel() + k.numel() + got.numel()) * es
            flops = 2 * n * h * w * cin * cout * 9
            b_ms, b_bytes, b_ops = bound(nbytes, flops, dtype)
            row = {"key": shape, "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bytes_ms": b_bytes, "ops_ms": b_ops,
                   "flops": flops, **rate(flops, ms, b_ms)}
            if dtype == torch.float32:
                row["plan"] = f32_plan(*shape)
                print(f"  B1 float32  {shape}: plan {row['plan']}",
                      flush=True)
            b1_rows.append(row)
            print(f"  B1 {row['dtype']:8s} {shape}: max|diff| {err:.3e} "
                  f"(bar {bar:.3e}) kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms; {row['tflops']:.1f} TFLOP/s, "
                  f"{row['bound_share']:.3f} of the bound", flush=True)
            if not err <= bar:
                fail(f"B1 {row['dtype']} {shape}: max|diff| {err} > {bar}")
            del x, k, got, ref

    # --------------------------------------- 4 B1 backward vs plain
    phase("B1 backward: dgrad (B1 on flipped weights) and the wgrad kernel "
          "vs their plain versions (batch 256; phase 31's tp, sp and pp "
          "shapes)")
    bwd_rows = []
    for dtype in dtypes:
        for shape in (TRAIN_STEM, TRAIN_L1, TRAIN_L2) + (
                (TRAIN_MNIST,) if dtype == torch.float32 else ()) + tuple(
                    MESH_SHAPES):
            n, h, w, cin, cout = shape
            es = torch.tensor([], dtype=dtype).element_size()
            flops = 2 * n * h * w * cin * cout * 9
            k = randn((3, 3, cin, cout), (9 * cout) ** -0.5, 2, dtype)
            dy = randn((n, h, w, cout), 1.0, 9, dtype)
            x = randn((n, h, w, cin), 1.0, 1, dtype)
            k_cl = k.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            dy_cl, x_cl = dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2)
            # dgrad: dx (n, h, w, cin) of the forward conv (cin -> cout)
            path = (f32_plan(n, h, w, cout, cin) if dtype == torch.float32
                    else conv3x3_path(n, h, w, cout, cin, dtype, dev))
            got = conv3x3_dgrad(dy, k)
            torch.cuda.synchronize()
            ref = reference_conv3x3(dy, flip_weights(k))
            err = (got.float() - ref.float()).abs().max().item()
            refmax = ref.float().abs().max().item()
            bar = (1e-4 * max(1.0, refmax) if dtype == torch.float32
                   else 2.0 ** -7 * refmax)
            ms = time_ms(lambda: conv3x3_dgrad(dy, k), 20)
            plain_ms = time_ms(
                lambda: reference_conv3x3(dy, flip_weights(k)), 20)
            lib_ms = time_ms(lambda: torch.nn.grad.conv2d_input(
                (n, cin, h, w), k_cl, dy_cl, padding=1), 20)
            b_ms, b_bytes, b_ops = bound(
                (dy.numel() + k.numel() + got.numel()) * es, flops, dtype)
            row = {"kind": "dgrad", "key": shape, "path": path,
                   "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bytes_ms": b_bytes, "ops_ms": b_ops,
                   "flops": flops, **rate(flops, ms, b_ms)}
            bwd_rows.append(row)
            print(f"  dgrad {row['dtype']:8s} {shape} ({cout}->{cin}), path "
                  f"{path}: max|diff| {err:.3e} (bar {bar:.3e}) kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms; {row['tflops']:.1f} TFLOP/s, "
                  f"{row['bound_share']:.3f} of the bound", flush=True)
            if not err <= bar:
                fail(f"dgrad {row['dtype']} {shape}: max|diff| {err} > {bar}")
            if dtype == torch.bfloat16 and shape == TRAIN_STEM \
                    and path != "halo_narrow":
                fail(f"the bf16 stem dgrad took the {path} path, not the "
                     f"narrow halo kernel")
            # wgrad: dW (3, 3, cin, cout); f32: sums over n*h*w pixels in
            # another order, 1e-5 of the largest; bf16: one rounding flip
            plan = wgrad_plan(n, h, w, cin, cout, dtype, sms)
            print(f"  wgrad {str(dtype).split('.')[-1]:8s} {shape}: plan "
                  f"{plan.path}, {plan.splits} K ranges, "
                  f"{plan.rows} {'image rows' if plan.path == 'tma' else 'pixels'}"
                  f" a step, {plan.stages} ring slots", flush=True)
            if dtype == torch.bfloat16 and shape in (TRAIN_L1, TRAIN_L2) \
                    and plan.path != "tma":
                fail(f"the bf16 wgrad at {shape} is planned on {plan.path}, "
                     f"not on TMA")
            if dtype == torch.float32 and plan.path != "f32":
                fail(f"the f32 wgrad at {shape} is planned on {plan.path}")
            got = conv3x3_wgrad(x, dy)
            again = conv3x3_wgrad(x, dy)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                fail(f"wgrad {dtype} {shape}: two launches differ")
            ref = reference_conv3x3_wgrad(x, dy)
            err = (got.float() - ref.float()).abs().max().item()
            refmax = ref.float().abs().max().item()
            bar = (1e-5 * max(1.0, refmax) if dtype == torch.float32
                   else 2.0 ** -7 * refmax)
            ms = time_ms(lambda: conv3x3_wgrad(x, dy), 20)
            plain_ms = time_ms(lambda: reference_conv3x3_wgrad(x, dy), 20)
            lib_ms = time_ms(lambda: torch.nn.grad.conv2d_weight(
                x_cl, (cout, cin, 3, 3), dy_cl, padding=1), 20)
            b_ms, b_bytes, b_ops = bound(
                (x.numel() + dy.numel() + got.numel()) * es, flops, dtype)
            row = {"kind": "wgrad", "key": shape, "plan": plan._asdict(),
                   "dtype": str(dtype).split(".")[-1], "max_abs_err": err,
                   "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bytes_ms": b_bytes, "ops_ms": b_ops,
                   "flops": flops, **rate(flops, ms, b_ms)}
            bwd_rows.append(row)
            print(f"  wgrad {row['dtype']:8s} {shape}: max|diff| {err:.3e} "
                  f"(bar {bar:.3e}), bits repeat; kernel {ms:.4f} ms, plain "
                  f"{plain_ms:.4f} ms, cuDNN {lib_ms:.4f} ms, bound "
                  f"{b_ms:.4f} ms; {row['tflops']:.1f} TFLOP/s, "
                  f"{row['bound_share']:.3f} of the bound", flush=True)
            if not err <= bar:
                fail(f"wgrad {row['dtype']} {shape}: max|diff| {err} > {bar}")
            del k, dy, x, k_cl, dy_cl, x_cl, got, again, ref
    torch.cuda.empty_cache()

    # ----------------------------------------------------- 5 B2 vs plain
    phase(f"B2 ode_block_rk2_forward vs its plain version (u={U}, "
          f"{N_STEPS} steps)")
    b2_rows = []
    for dtype in dtypes:
        for _, n, h, w, c in B2_CALLS:
            y0 = randn((n, h, w, c), 0.5, 3, dtype)
            w1 = randn((3, 3, c, c), (9 * c) ** -0.5, 4, dtype)
            w2 = randn((3, 3, c, c), (9 * c) ** -0.5, 5, dtype)
            got = ode_block_rk2_forward(y0, w1, w2, U, N_STEPS)
            torch.cuda.synchronize()
            ref = reference_ode_block_rk2(y0, w1, w2, U, N_STEPS)
            err = (got.float() - ref.float()).abs().max().item()
            refmax = ref.float().abs().max().item()
            # f32: sum order only; bf16: the kernel and the plain version
            # round at the same points, but a rounding of h, of the stage
            # input or of y may flip and carry on: four bf16 ulps of the
            # largest state
            bar = (1e-4 * max(1.0, refmax) if dtype == torch.float32
                   else 2.0 ** -5 * refmax)
            ms = time_ms(lambda: ode_block_rk2_forward(y0, w1, w2, U,
                                                       N_STEPS), 5)
            plain_ms = time_ms(lambda: reference_ode_block_rk2(
                y0, w1, w2, U, N_STEPS), 5)
            es = y0.element_size()
            nbytes = (2 * y0.numel() + w1.numel() + w2.numel()) * es
            flops = N_STEPS * 2 * 2 * (2 * n * h * w * c * c * 9)
            b_ms, b_bytes, b_ops = bound(nbytes, flops, dtype)
            row = {"key": (n, h, w, c), "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": None,
                   "bound_ms": b_ms, "bytes_ms": b_bytes, "ops_ms": b_ops,
                   "flops": flops, **rate(flops, ms, b_ms)}
            b2_rows.append(row)
            print(f"  B2 {row['dtype']:8s} {(n, h, w, c)}: max|diff| "
                  f"{err:.3e} (bar {bar:.3e}) kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms; "
                  f"{row['tflops']:.1f} TFLOP/s, {row['bound_share']:.3f} "
                  f"of the bound", flush=True)
            if not err <= bar:
                fail(f"B2 {row['dtype']} {(n, h, w, c)}: max|diff| {err} "
                     f"> {bar}")
            del y0, w1, w2, got, ref
    torch.cuda.empty_cache()

    # ----------------------------------------------------- 6 B3 vs plain
    phase(f"B3 fused_group_norm_act vs its plain version (batch 256, "
          f"{GN_GROUPS} groups)")
    # the launch floor: a one-element add_ in the same kind of graph replay
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda: one.add_(1.0), 20)
    print(f"  launch floor (one-element add_, graph replay): {floor_ms:.5f} "
          f"ms", flush=True)
    b3_rows = []
    for dtype in dtypes:
        # phase 18's and 20's shapes run in bf16 only
        for _, n, h, w, c, act, _ in B3_CALLS + B3_OFF_PATH + (
                B3_CIFAR_CALLS + B3_WIDE_CALLS
                if dtype == torch.bfloat16 else []):
            plan = launch_plan(n, h, w, c, GN_GROUPS, dtype)
            x = (randn((n, h, w, c), 2.0, 6, torch.float32) + 0.5).to(dtype)
            scale = randn((c,), 0.3, 7, torch.float32) + 1.0
            bias = randn((c,), 0.5, 8, torch.float32)
            got = fused_group_norm_act(x, scale, bias, GN_GROUPS, act=act)
            torch.cuda.synchronize()
            ref = group_norm_reference(x, scale, bias, GN_GROUPS, act=act)
            err = (got.float() - ref.float()).abs().max().item()
            refmax = ref.float().abs().max().item()
            # f32: the JAX test's 2e-4 (sum order, rsqrt); bf16: the kernel
            # and its plain version round once, at the same point, so a
            # rounding may flip: two bf16 ulps of the largest output
            bar = (2e-4 * max(1.0, refmax) if dtype == torch.float32
                   else 2.0 ** -6 * refmax)
            ms = time_ms(lambda: fused_group_norm_act(
                x, scale, bias, GN_GROUPS, act=act), 20)
            plain_ms = time_ms(lambda: group_norm_reference(
                x, scale, bias, GN_GROUPS, act=act), 20)
            # yardstick: F.group_norm on the channels_last NCHW view (its
            # affine in x's dtype), then torch.relu or F.gelu where B3
            # fuses the activation
            x_cl = x.permute(0, 3, 1, 2)
            s_l, b_l = scale.to(dtype), bias.to(dtype)
            lib_act = {None: lambda y: y, "relu": torch.relu,
                       "gelu": torch.nn.functional.gelu}[act]

            def library():
                return lib_act(torch.nn.functional.group_norm(
                    x_cl, GN_GROUPS, s_l, b_l, 1e-5))

            lib_ms = time_ms(library, 20)
            nbytes = 2 * x.numel() * x.element_size() + 2 * c * 4
            flops = GN_OPS_PER_ELEMENT * x.numel()
            b_ms, b_bytes, b_ops = bound(nbytes, flops, torch.float32)
            row = {"key": (n, h, w, c, act),
                   "dtype": str(dtype).split(".")[-1],
                   "max_abs_err": err, "ms": ms,
                   "plain_ms": plain_ms, "library_ms": lib_ms,
                   "bound_ms": b_ms, "bytes_ms": b_bytes, "ops_ms": b_ops,
                   "plan": plan._asdict()}
            b3_rows.append(row)
            print(f"  B3 {row['dtype']:8s} {(n, h, w, c)} act={act}: plan "
                  f"{plan.path} ({plan.vec}-element access, {plan.warps} "
                  f"warps a block, cluster {plan.cluster}, {plan.regs} "
                  f"vectors a thread, {plan.smem_bytes} B shared)", flush=True)
            print(f"     max|diff| {err:.3e} (bar {bar:.3e}) kernel {ms:.4f} "
                  f"ms ({ms - floor_ms:.4f} above the floor), plain "
                  f"{plain_ms:.4f} ms, F.group_norm{'+' + act if act else ''} "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_ms / ms:.3f} of it)", flush=True)
            if not err <= bar:
                fail(f"B3 {row['dtype']} {(n, h, w, c)} act={act}: "
                     f"max|diff| {err} > {bar}")
            del x, got, ref, x_cl
    torch.cuda.empty_cache()

    # ------------------------------------------- 6b B3 backward vs plain
    phase(f"B3 backward (group_norm_backward) vs its plain version (the "
          f"MNIST train step's shapes at batch {MNIST_TRAIN_BATCH}, "
          f"{GN_GROUPS} groups)")
    b3b_rows = []
    for dtype in dtypes:
        for _, n, h, w, c, act, _ in B3_BWD_CALLS + B3_BWD_OFF_PATH + (
                B3_CIFAR_CALLS + B3_WIDE_CALLS
                if dtype == torch.bfloat16 else []):
            plan = launch_plan(n, h, w, c, GN_GROUPS, dtype, backward=True)
            x = (randn((n, h, w, c), 2.0, 6, torch.float32) + 0.5).to(dtype)
            scale = randn((c,), 0.3, 7, torch.float32) + 1.0
            bias = randn((c,), 0.5, 8, torch.float32)
            g = randn((n, h, w, c), 1.0, 9, dtype)
            args = (x, scale, bias, g, GN_GROUPS)
            full = group_norm_backward(*args, act=act)
            again = group_norm_backward(*args, act=act)
            dx_only, none_s, _ = group_norm_backward(*args, act=act,
                                                     params=False)
            torch.cuda.synchronize()
            if none_s is not None or not torch.equal(full[0], dx_only) or \
                    not all(torch.equal(a, b) for a, b in zip(full, again)):
                fail(f"B3 backward {dtype} {(n, h, w, c)}: two launches "
                     f"differ, or the dx-only launch's dx differs")
            ref = group_norm_backward_reference(*args, act=act)
            errs = [(a.float() - b.float()).abs().max().item()
                    for a, b in zip(full, ref)]
            # dx: f32 the sum order (1e-4 of the largest), bf16 one rounding
            # at the same point (two bf16 ulps of the largest); dscale and
            # dbias: f32 sums of N*H*W terms in another order, 1e-5 of the
            # sum of their magnitudes (|dpre| <= 2 |dout| for these acts)
            dxmax = ref[0].float().abs().max().item()
            xf = x.float().reshape(n, h * w, GN_GROUPS, c // GN_GROUPS)
            xhat = ((xf - xf.mean((1, 3), keepdim=True)) * torch.rsqrt(
                xf.var((1, 3), unbiased=False, keepdim=True) + 1e-5)
                    ).reshape(n, h, w, c)
            l1 = 2.0 * g.float().abs()
            bars = [1e-4 * max(1.0, dxmax) if dtype == torch.float32
                    else 2.0 ** -6 * dxmax,
                    1e-5 * max(1.0, (l1 * xhat.abs()).sum().item()),
                    1e-5 * max(1.0, l1.sum().item())]
            del xf, xhat, l1
            ms_full = time_ms(lambda: group_norm_backward(*args, act=act), 20)
            ms_dx = time_ms(lambda: group_norm_backward(*args, act=act,
                                                        params=False), 20)
            plain_ms = time_ms(lambda: group_norm_backward_reference(
                *args, act=act), 20)
            # yardstick: PyTorch's own GroupNorm backward, aten's, as
            # autograd calls it after F.group_norm of the channels_last
            # NCHW view (which hands aten a contiguous NCHW copy), with the
            # forward's saved statistics, after the relu mask or GELU's
            # backward; its affine in x's dtype
            x_cl = x.permute(0, 3, 1, 2).contiguous()
            g_cl = g.permute(0, 3, 1, 2).contiguous()
            s_l = scale.to(dtype)
            y_l, mean_l, rstd_l = torch.ops.aten.native_group_norm(
                x_cl, s_l, bias.to(dtype), n, c, h * w, GN_GROUPS, 1e-5)

            def library():
                gy = (torch.ops.aten.threshold_backward(g_cl, y_l, 0.0)
                      if act == "relu" else
                      torch.ops.aten.gelu_backward(g_cl, y_l)
                      if act == "gelu" else g_cl)
                return torch.ops.aten.native_group_norm_backward(
                    gy, x_cl, mean_l, rstd_l, s_l, n, c, h * w, GN_GROUPS,
                    [True, True, True])

            lib_ms = time_ms(library, 20)
            es = x.element_size()
            flops = GN_BWD_OPS_PER_ELEMENT * x.numel()
            for kind_, ms, extra in (("full", ms_full, 2 * c * 4),
                                     ("dx", ms_dx, 0)):
                b_ms, b_bytes, b_ops = bound(3 * x.numel() * es + extra,
                                             flops, torch.float32)
                b3b_rows.append({
                    "key": (n, h, w, c, act, kind_),
                    "dtype": str(dtype).split(".")[-1],
                    "max_abs_err": max(errs), "ms": ms,
                    "plain_ms": plain_ms, "library_ms": lib_ms,
                    "bound_ms": b_ms, "bytes_ms": b_bytes, "ops_ms": b_ops,
                    "plan": plan._asdict()})
            print(f"  B3 bwd {str(dtype).split('.')[-1]:8s} {(n, h, w, c)} "
                  f"act={act}: plan {plan.path} ({plan.vec}-element access, "
                  f"{plan.warps} warps a block, cluster {plan.cluster}, "
                  f"{plan.regs} vectors a thread, {plan.smem_bytes} B "
                  f"shared{', dxhat kept there' if plan.stash else ''}); "
                  f"bits repeat", flush=True)
            print(f"     max|diff| dx {errs[0]:.3e} (bar {bars[0]:.3e}), "
                  f"dscale {errs[1]:.3e} (bar {bars[1]:.3e}), dbias "
                  f"{errs[2]:.3e} (bar {bars[2]:.3e}); kernel {ms_full:.4f} "
                  f"ms (dx only {ms_dx:.4f}), plain {plain_ms:.4f} ms, aten "
                  f"GN backward{' after ' + act + ' backward' if act else ''} "
                  f"{lib_ms:.4f} "
                  f"ms, bound {b3b_rows[-1]['bound_ms']:.4f} ms "
                  f"({b3b_rows[-1]['bound_ms'] / ms_full:.3f} of it)",
                  flush=True)
            if not all(e <= b for e, b in zip(errs, bars)):
                fail(f"B3 backward {dtype} {(n, h, w, c)} act={act}: "
                     f"max|diff| {errs} > {bars}")
            del x, g, full, again, dx_only, ref, x_cl, g_cl, y_l
    torch.cuda.empty_cache()

    # ------------------------------------------------ 6c GeLUpoly vs plain
    phase("GeLUpoly (fused_gelu_poly, gelu_poly_backward) vs its plain "
          "versions (the flagship's activation shapes, bf16 and f32)")
    gelu = gelu_poly_phase(port, torch, dev, time_ms)

    def time_requests(served, sizes, make_input, label):
        """One warm-up request at each size, then REQUEST_ROUNDS counted and
        timed requests at each size; returns (launch counts, batches,
        requests, logits by request index)."""
        batches = sizes * REQUEST_ROUNDS
        requests = [make_input(b) for b in batches]
        for x in requests[:len(sizes)]:  # warm-up at each served batch
            served(x)                    # size, outside the counted run
        torch.cuda.synchronize()
        port.reset_launch_counts()
        req_ms, logits_by = [], []
        for x in requests:
            t0 = time.perf_counter()
            logits = served(x)
            torch.cuda.synchronize()
            req_ms.append((time.perf_counter() - t0) * 1e3)
            if tuple(logits.shape) != (x.shape[0], 10) \
                    or logits.dtype != torch.float32:
                fail(f"logits {tuple(logits.shape)} {logits.dtype} for "
                     f"batch {x.shape[0]}")
            if not torch.isfinite(logits).all():
                fail(f"non-finite logits for batch {x.shape[0]}")
            logits_by.append(logits)
        counts = port.launch_counts()
        print(f"  requests (batch): {batches}", flush=True)
        print(f"  ms per request: {[round(m, 3) for m in req_ms]}",
              flush=True)
        for b in sizes:
            ms_b = sorted(m for m, bb in zip(req_ms, batches) if bb == b)
            med = ms_b[len(ms_b) // 2]
            print(f"  batch {b}: median {med:.3f} ms over {len(ms_b)} "
                  f"requests (min {ms_b[0]:.3f}, max {ms_b[-1]:.3f}) = "
                  f"{b / med * 1e3:.1f} img/s ({label})", flush=True)
        return counts, batches, requests, logits_by

    # ------------------------------------------------------------ 7 serve
    cudnn.allow_tf32, matmul.allow_tf32 = tf32_defaults
    print(f"serving under the process's TF32 flags: cudnn.allow_tf32 "
          f"{cudnn.allow_tf32}, matmul.allow_tf32 {matmul.allow_tf32} "
          f"(the model computes f32 in full f32 regardless)", flush=True)
    phase("serve premetanode10 (in_planes 64) in bf16")
    model = build_model("premetanode10", in_planes=64,
                        generator=torch.Generator().manual_seed(0))
    if model.device.type != "cuda":
        fail(f"model built on {model.device}, not on the card")
    solvers = parse_solver_dsl(f"rk2,u,{N_STEPS},-1,{U},-1")
    served = ServedModel(model, solvers, SolverOptions(),
                         compute_dtype=torch.bfloat16)
    gen_cpu = torch.Generator().manual_seed(7)
    counts, batches, requests, logits_bf16 = time_requests(
        served, [1, 64, BATCH],
        lambda b: torch.rand(b, 32, 32, 3, generator=gen_cpu), "bf16")
    per_request = {"conv3x3_same": len(B1_CALLS),
                   "ode_block_rk2": len(B2_CALLS) * B2_LAUNCHES_PER_SOLVE}
    expected = {k: v * len(batches) for k, v in per_request.items()}
    print(f"  launch counts: {counts} (expected {expected}: B1 "
          f"{len(B1_CALLS)} and B2 {len(B2_CALLS)} x (4 x {N_STEPS} + 1) "
          f"per request, {len(batches)} requests)", flush=True)
    if counts != expected:
        fail(f"launch counts {counts} != expected {expected}")
    cifar_counts, cifar_requests = counts, len(batches)

    # the served bf16 logits against the same model's plain path in bf16:
    # the plain path keeps k1/k2 in bf16 where B2 keeps them in f32 (as the
    # Pallas kernel does), so the two differ by the roundings of two 8-step
    # solves; the bar is four bf16 ulps of the largest logit
    x = requests[1]  # batch 64
    with torch.inference_mode():
        logits_p = model(x.to(dev).to(torch.bfloat16), solvers,
                         SolverOptions(), use_kernels=False).float()
    torch.cuda.synchronize()
    bf16_err = (logits_bf16[1] - logits_p).abs().max().item()
    bf16_bar = 2.0 ** -5 * logits_p.abs().max().item()
    print(f"  bf16 served logits vs plain path on the card (batch 64): "
          f"max|diff| {bf16_err:.3e} (bar {bf16_bar:.3e})", flush=True)
    if not bf16_err <= bf16_bar:
        fail(f"bf16 serving differs from the plain path by {bf16_err}")

    served_f32 = ServedModel(model, solvers, SolverOptions())
    logits_k = served_f32(x)
    with torch.inference_mode():
        logits_p = model(x.to(dev), solvers, SolverOptions(),
                         use_kernels=False).float()
    torch.cuda.synchronize()
    serve_err = (logits_k - logits_p).abs().max().item()
    serve_bar = 3e-4  # the repo's f32 forward parity bar
    print(f"  f32 served logits vs plain path on the card (batch 64): "
          f"max|diff| {serve_err:.3e} (bar {serve_bar})", flush=True)
    if not serve_err <= serve_bar:
        fail(f"f32 serving differs from the plain path by {serve_err}")
    del model, served, served_f32, requests, logits_bf16
    torch.cuda.empty_cache()

    # ------------------------------------------------------- 8 serve MNIST
    phase(f"serve the MNIST MetaNODE (dim {MNIST_DIM}) in f32")
    mnist = build_model("mnist", dim=MNIST_DIM,
                        generator=torch.Generator().manual_seed(0))
    if mnist.device.type != "cuda":
        fail(f"MNIST model built on {mnist.device}, not on the card")
    mnist_served = ServedModel(mnist, solvers, SolverOptions())
    counts, batches, requests, logits_f32 = time_requests(
        mnist_served, [1, 128, BATCH],
        lambda b: torch.rand(b, 28, 28, 1, generator=gen_cpu), "f32")
    per_request = {"group_norm_act": sum(c[-1] for c in B3_CALLS),
                   "conv3x3_same": sum(c[-1] for c in B1_MNIST_CALLS)}
    expected = {k: v * len(batches) for k, v in per_request.items()}
    print(f"  launch counts: {counts} (expected {expected}: B3 "
          f"{per_request['group_norm_act']}, B1 "
          f"{per_request['conv3x3_same']} and B2 0 per request, "
          f"{len(batches)} requests)", flush=True)
    if counts != expected:
        fail(f"MNIST launch counts {counts} != expected {expected}")
    mnist_counts, mnist_requests = counts, len(batches)

    # the served f32 logits against the same model's plain path on the
    # card, at the repo's MNIST serving bar (tests/test_shipped_artifact.py)
    x = requests[1]  # batch 128
    with torch.inference_mode():
        logits_p = mnist(x.to(dev), solvers, SolverOptions(),
                         use_kernels=False).float()
    torch.cuda.synchronize()
    mnist_err = (logits_f32[1] - logits_p).abs().max().item()
    mnist_bar = 1e-4 * max(1.0, logits_p.abs().max().item())
    print(f"  f32 served logits vs plain path on the card (batch 128): "
          f"max|diff| {mnist_err:.3e} (bar {mnist_bar:.3e})", flush=True)
    if not mnist_err <= mnist_bar:
        fail(f"MNIST f32 serving differs from the plain path by "
             f"{mnist_err}")

    del mnist, mnist_served, requests, logits_f32
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ 9 train
    phase(f"train: the flagship adversarial step (premetanode10, in_planes "
          f"64, GeLUpoly), bf16, batch {BATCH}")
    model = build_model("premetanode10", in_planes=64,
                        acts=("GeLUpoly",) * 3,
                        generator=torch.Generator().manual_seed(0))
    gen_cpu.manual_seed(1)
    x_train = torch.randn(BATCH, 32, 32, 3, generator=gen_cpu).to(dev)
    y_train = torch.randint(0, 10, (BATCH,), generator=gen_cpu).to(dev)
    # ------------------------------------------------ 10 train vs plain
    train_counts, med, train_peak = train_step_phase(
        port, torch, dev, model, "train", TRAIN_PER_STEP, solvers, x_train,
        y_train, compare_attacks=True)
    del model
    torch.cuda.empty_cache()

    # ------------------------------------------------- 11 train MNIST
    phase(f"train: the digits recipe (MNIST MetaNODE dim {MNIST_DIM}, "
          f"PGD-{PGD_ITERS}, smoothing, RMSprop), f32, batch "
          f"{MNIST_TRAIN_BATCH}")
    mnist = build_model("mnist", dim=MNIST_DIM,
                        generator=torch.Generator().manual_seed(0))
    mopt = make_optimizer("rmsprop", 1e-3, weight_decay=5e-4)
    matk = AttackConfig(mode="at", eps=PGD_EPS, pgd_lr=PGD_LR,
                        pgd_niter=PGD_ITERS)
    noise_cfg = NoiseConfig(noise_type="normal", sigma=0.0125, prob=1.0)

    def mnist_step(use_kernels):
        return make_train_step(mnist, mopt, solvers, SolverOptions(), matk,
                               noise_cfg, use_kernels=use_kernels)

    mstate = create_train_state(mnist, mopt)
    msnap = {k: p.detach().clone() for k, p in mstate.params.items()}
    gen_cpu.manual_seed(2)
    xm = torch.rand(MNIST_TRAIN_BATCH, 28, 28, 1, generator=gen_cpu).to(dev)
    ym = torch.randint(0, 10, (MNIST_TRAIN_BATCH,), generator=gen_cpu).to(dev)
    step = mnist_step(True)
    step_gen = torch.Generator().manual_seed(11)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mstate, metrics = step(mstate, xm, ym, step_gen)  # warm-up
    torch.cuda.synchronize()
    print(f"  warm-up step: {(time.perf_counter() - t0) * 1e3:.1f} ms, loss "
          f"{metrics['loss'].item():.6f}", flush=True)
    port.reset_launch_counts()
    mstep_ms, losses = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        mstate, metrics = step(mstate, xm, ym, step_gen)
        torch.cuda.synchronize()
        mstep_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"].item())
    mnist_train_counts = port.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    mnist_med = sorted(mstep_ms)[len(mstep_ms) // 2]
    print(f"  losses: {[round(l, 6) for l in losses]}", flush=True)
    print(f"  ms per step: {[round(m, 3) for m in mstep_ms]}", flush=True)
    print(f"  median {mnist_med:.3f} ms per step over {TRAIN_STEPS} steps "
          f"(min {min(mstep_ms):.3f}, max {max(mstep_ms):.3f}) = "
          f"{MNIST_TRAIN_BATCH / mnist_med * 1e3:.1f} img/s (f32, batch "
          f"{MNIST_TRAIN_BATCH}); peak memory {peak_gb:.2f} GiB", flush=True)
    if not all(math.isfinite(l) for l in losses):
        fail(f"non-finite MNIST training loss: {losses}")
    expected = {k: v * TRAIN_STEPS for k, v in MNIST_TRAIN_PER_STEP.items()}
    print(f"  launch counts: {mnist_train_counts} (expected {expected}: per "
          f"step {PGD_ITERS + 1} forwards of B3 {MNIST_GN_PER_PASS} and B1 "
          f"{MNIST_B1_PER_PASS}, {PGD_ITERS + 1} backwards of B3 and dgrad, "
          f"{MNIST_GN_PER_PASS} of B3's with dscale/dbias and "
          f"{MNIST_B1_PER_PASS} wgrad in the training pass's, B2 0; "
          f"{TRAIN_STEPS} steps)", flush=True)
    if mnist_train_counts != expected:
        fail(f"MNIST train launch counts {mnist_train_counts} != expected "
             f"{expected}")

    # kernel path vs plain path from one state, draws pinned by the seeds
    def mrestore():
        with torch.no_grad():
            for k, p in mstate.params.items():
                p.copy_(msnap[k])

    results = {}
    for use_kernels in (True, False):
        mrestore()
        st = create_train_state(mnist, mopt)
        _, mt = mnist_step(use_kernels)(st, xm, ym,
                                        torch.Generator().manual_seed(21))
        results[use_kernels] = (mt["loss"].item(), mt["grad_norm"].item())
    (lk, nk), (lp, np_) = results[True], results[False]
    loss_bar = 2e-2 * max(1.0, abs(lp))
    norm_rel = abs(nk - np_) / np_
    print(f"  f32 batch {MNIST_TRAIN_BATCH}: loss {lk:.6f} vs plain "
          f"{lp:.6f} (|diff| {abs(lk - lp):.3e}, bar {loss_bar:.3e}); grad "
          f"norm {nk:.6f} vs {np_:.6f} (relative {norm_rel:.3e}, bar 5e-2; "
          f"PGD's sign steps carry rounding differences on)", flush=True)
    if not (abs(lk - lp) <= loss_bar and norm_rel <= 5e-2):
        fail("MNIST train step: kernel and plain paths disagree")
    mrestore()
    mfrozen = mnist.detached_params()
    mparams = list(mstate.params.values())
    xb, yb = xm[:32], ym[:32]
    with full_f32():
        def mfwd(use_kernels, train, tree=None):
            return lambda xi: mnist(xi, solvers, use_kernels=use_kernels,
                                    train=train, params=tree)

        xa = [pgd(mfwd(uk, False, mfrozen),
                  torch.Generator(device=dev).manual_seed(4), xb, yb,
                  PGD_EPS, PGD_LR, 1)[0] for uk in (True, False)]
        share = (xa[0] != xa[1]).float().mean().item()
        grads = [torch.autograd.grad(cross_entropy(
            mfwd(uk, True)(xa[1]), yb), mparams) for uk in (True, False)]
        gmax = max(g.abs().max().item() for g in grads[1])
        gerr = max((a - b).abs().max().item() for a, b in zip(*grads))
    # the bar: ReLU masks at pre-activations within rounding of 0 flip
    # between two forwards that differ by rounding (B3's forward kernel and
    # its plain version, 1e-7 apart); at this random init, 1e-6 relative
    # noise on every GroupNorm's output moves these grads by 3.1e-3 of
    # max|g| (on the CPU), so 1e-3 (the flagship's GeLUpoly has no masks:
    # 1e-4 there)
    print(f"  f32 batch 32, through Model.forward: one PGD step's x_adv "
          f"differs at {share:.2e} of the pixels (at most 1e-3); param "
          f"grads at the plain x_adv, max|diff| {gerr:.3e} (bar 1e-3 x "
          f"max|g| = {1e-3 * gmax:.3e})", flush=True)
    if share > 1e-3 or not gerr <= 1e-3 * gmax:
        fail(f"MNIST kernel and plain paths differ: x_adv share {share}, "
             f"grads {gerr}")
    del grads, xa

    # --------------------------------------------------- 12 evaluate MNIST
    phase(f"evaluate: clean accuracy and PGD-{PGD_ITERS} adversarial "
          f"accuracy, {EVAL_BATCHES} batches of {EVAL_BATCH}, f32")
    mrestore()
    gen_cpu.manual_seed(3)
    eval_data = [(torch.rand(EVAL_BATCH, 28, 28, 1, generator=gen_cpu)
                  .to(dev), torch.randint(0, 10, (EVAL_BATCH,),
                                          generator=gen_cpu).to(dev))
                 for _ in range(EVAL_BATCHES)]
    eatk = AttackConfig(mode="at", eps=PGD_EPS, pgd_lr=PGD_LR,
                        pgd_niter=PGD_ITERS)

    def timed(batches, marks):
        """The batches, with a synchronized host-clock mark before each
        and after the last (the harness itself reads back only at the
        end)."""
        for b in batches:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            yield b
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    evals = {}
    for use_kernels in (True, False):
        predict = make_eval_step(mnist, solvers, use_kernels=use_kernels)
        apredict = make_adversarial_predict(mnist, solvers, SolverOptions(),
                                            eatk, use_kernels=use_kernels)
        predict(eval_data[0][0])  # warm-up
        apredict(*eval_data[0], torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        port.reset_launch_counts()
        marks = []
        acc = accuracy(mnist, solvers, SolverOptions(),
                       timed(eval_data, marks), predict=predict)
        clean_counts = port.launch_counts()
        port.reset_launch_counts()
        amarks = []
        rob = adversarial_accuracy(mnist, solvers, SolverOptions(),
                                   timed(eval_data, amarks), eatk,
                                   torch.Generator().manual_seed(5),
                                   predict=apredict)
        evals[use_kernels] = dict(
            acc=acc, rob=rob, clean_counts=clean_counts,
            pgd_counts=port.launch_counts(),
            clean_ms=[(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
            pgd_ms=[(b - a) * 1e3 for a, b in zip(amarks, amarks[1:])])
        e = evals[use_kernels]
        print(f"  {'kernel' if use_kernels else 'plain '} path: clean "
              f"accuracy {acc:.4f} (ms per batch "
              f"{[round(m, 3) for m in e['clean_ms']]}), PGD-{PGD_ITERS} "
              f"accuracy {rob:.4f} (ms per batch "
              f"{[round(m, 3) for m in e['pgd_ms']]}); launches clean "
              f"{e['clean_counts']}, PGD {e['pgd_counts']}", flush=True)
    ek, ep = evals[True], evals[False]
    want_clean = {k: v * EVAL_BATCHES for k, v in EVAL_CLEAN_PER_BATCH.items()}
    want_pgd = {k: v * EVAL_BATCHES for k, v in EVAL_PGD_PER_BATCH.items()}
    n_eval = EVAL_BATCHES * EVAL_BATCH
    pgd_apart = abs(round(ek["rob"] * n_eval) - round(ep["rob"] * n_eval))
    print(f"  expected launches: clean {want_clean}, PGD {want_pgd} (plain "
          f"path none); correct counts kernel vs plain: clean "
          f"{round(ek['acc'] * n_eval)} vs {round(ep['acc'] * n_eval)} "
          f"(equal), PGD {round(ek['rob'] * n_eval)} vs "
          f"{round(ep['rob'] * n_eval)} (at most 2 of {n_eval} apart: "
          f"sign steps)", flush=True)
    if ek["clean_counts"] != want_clean or ek["pgd_counts"] != want_pgd \
            or ep["clean_counts"] or ep["pgd_counts"]:
        fail("evaluation launch counts differ from the expected ones")
    if round(ek["acc"] * n_eval) != round(ep["acc"] * n_eval) \
            or pgd_apart > 2:
        fail("evaluation: kernel and plain paths count differently")
    eval_counts = Counter(ek["clean_counts"]) + Counter(ek["pgd_counts"])
    del mnist, mstate, msnap, eval_data
    torch.cuda.empty_cache()

    # ------------------------------------------------ 13, 14 regime tables
    def regime_evaluators(model, spec, fgsm_cfg, dtype, use_kernels):
        """(clean, fgsm): the accuracy entry points of ``spec``'s regime,
        each ``f(data, generator, out)`` appending every batch's scores
        (logits, or the ensemble's mean softmax) to ``out``."""
        def keep(fn, out):
            def scores(*args):
                out.append(fn(*args).float())
                return out[-1]
            return scores

        if spec.is_model_ensemble:
            members = [(model, [s], SolverOptions()) for s in spec.solvers]
            probs = make_ensemble_probs(members, compute_dtype=dtype,
                                        use_kernels=use_kernels)
            atk = make_ensemble_attacked_probs(
                members, fgsm_cfg, compute_dtype=dtype,
                use_kernels=use_kernels)
            return (lambda d, g, out: accuracy_ensemble(
                        members, d, g, predict=keep(probs, out)),
                    lambda d, g, out: adversarial_accuracy_ensemble(
                        members, d, fgsm_cfg, g, predict=keep(atk, out)))
        sv, opts = list(spec.solvers), spec.options
        predict = make_eval_step(model, sv, opts, compute_dtype=dtype,
                                 use_kernels=use_kernels)
        apredict = make_adversarial_predict(model, sv, opts, fgsm_cfg,
                                            compute_dtype=dtype,
                                            use_kernels=use_kernels)
        return (lambda d, g, out: accuracy(model, sv, opts, d,
                                           predict=keep(predict, out),
                                           generator=g),
                lambda d, g, out: adversarial_accuracy(
                    model, sv, opts, d, fgsm_cfg, g,
                    predict=keep(apredict, out)))

    def gen_of(seed):
        return None if seed is None else torch.Generator().manual_seed(seed)

    def regime_table(label, model, grid, data, fgsm_cfg, dtype, logit_bar,
                     forward_counts, attack_counts, x_adv_bar, grad_bar,
                     far_bar, sweep=()):
        """The Evaluate-notebook table on ``model`` over ``data``: per
        regime clean and FGSM accuracy, kernel path and plain path from
        the same seeds (clean 11, 13, ... where the regime draws; FGSM 10,
        12, ...).  Checks the launch counts per batch
        (``forward_counts(kind, n)`` a clean forward,
        ``attack_counts(kind, n)`` the attack's forward under grad),
        logits within ``logit_bar``, clean predictions equal wherever the
        plain path's top two scores are more than twice the paths' largest
        difference apart (where they are not, bf16 rounding may flip an
        argmax), FGSM counts within 2 a batch; on the first batch in f32
        (``fgsm_apart``) x_adv equal but at most 0.1% of the pixels, each
        with an input gradient under ``x_adv_bar`` of its max, the input
        gradients within ``grad_bar`` of their max and at most ``far_bar``
        of them more than 1e-3 of it apart (each bar where given; all
        printed), beside the same readings of the plain path in f64
        against f32, which show what rounding alone moves; with ``sweep``
        the clean counts at each step count.  Returns the kernel path's
        launches and the table's rows."""
        nb = len(data)
        totals, rows = Counter(), []
        for i, spec in enumerate(grid):
            kind = spec.name.split("[")[0]
            clean_seed = 11 + 2 * i if spec.needs_key else None
            fgsm_seed = 10 + 2 * i
            res = {}
            for uk in (True, False):
                clean, fgsm_eval = regime_evaluators(model, spec, fgsm_cfg,
                                                     dtype, uk)
                clean(data[:1], gen_of(clean_seed), [])  # warm-up
                fgsm_eval(data[:1], gen_of(fgsm_seed), [])
                torch.cuda.synchronize()
                port.reset_launch_counts()
                marks, c_out = [], []
                acc = clean(timed(data, marks), gen_of(clean_seed), c_out)
                c_counts = port.launch_counts()
                port.reset_launch_counts()
                amarks, f_out = [], []
                rob = fgsm_eval(timed(data, amarks), gen_of(fgsm_seed), f_out)
                f_counts = port.launch_counts()
                res[uk] = dict(
                    acc=acc, rob=rob, c_counts=c_counts, f_counts=f_counts,
                    c_out=c_out, f_out=f_out,
                    clean_ms=[(b - a) * 1e3 for a, b in zip(marks, marks[1:])],
                    fgsm_ms=[(b - a) * 1e3
                             for a, b in zip(amarks, amarks[1:])])
            k, p = res[True], res[False]
            # launches: the clean forward; FGSM's attack forward (under
            # grad, so the generic path: B1, never B2) with its backward
            # (B1's dgrad, B3's dx-only backward), then the clean forward
            want_c = forward_counts(kind, N_STEPS)
            atk = attack_counts(kind, N_STEPS)
            want_f = Counter(want_c) + Counter(atk) + Counter({
                "conv3x3_dgrad": atk.get("conv3x3_same", 0),
                "group_norm_act_bwd": atk.get("group_norm_act", 0)})
            want_c = {n: v * nb for n, v in want_c.items() if v}
            want_f = {n: v * nb for n, v in want_f.items() if v}
            if k["c_counts"] != want_c or k["f_counts"] != want_f \
                    or p["c_counts"] or p["f_counts"]:
                fail(f"{label} {spec.name}: launches clean {k['c_counts']} "
                     f"(expected {want_c}), FGSM {k['f_counts']} (expected "
                     f"{want_f}); plain path {p['c_counts']}, "
                     f"{p['f_counts']}")
            totals += Counter(k["c_counts"]) + Counter(k["f_counts"])
            ys = [yb for _, yb in data]
            hits = lambda out: [int((o.argmax(-1) == yb).sum())
                                for o, yb in zip(out, ys)]
            ck, cp = hits(k["c_out"]), hits(p["c_out"])
            flips = ties = 0
            for a, b in zip(k["c_out"], p["c_out"]):
                moved, near = argmax_apart(a, b)
                flips, ties = flips + moved, ties + near
            fk, fp = hits(k["f_out"]), hits(p["f_out"])
            if spec.is_model_ensemble:  # each member's logits
                errs, bars = zip(*member_logits_apart(
                    model, spec.solvers,
                    data[0][0] if dtype is None else data[0][0].to(dtype),
                    logit_bar))
            else:
                errs = [(a - b).abs().max().item()
                        for a, b in zip(k["c_out"], p["c_out"])]
                bars = [logit_bar(b) for b in p["c_out"]]
            x, y = data[0]
            fa, f64 = fgsm_apart(
                [member_forwards(model, spec, False, 99),
                 member_forwards(model, spec, True, 99),
                 member_forwards(model, spec, False, 99, f64=True)],
                x, y, fgsm_cfg.eps, fgsm_cfg.mean, fgsm_cfg.std)
            share, worst = fa["share"], fa["worst"]
            g_err, g_far = fa["grad_err"], fa["grad_far"]
            sweep_k, sweep_p = [], []
            for uk, accs in ((True, sweep_k), (False, sweep_p)):
                if not sweep:
                    break
                port.reset_launch_counts()
                if kind == "standalone":
                    accs += sn_test(model, spec.solvers[0], spec.options,
                                    lambda: iter(data), sweep,
                                    compute_dtype=dtype, use_kernels=uk)
                for n in sweep if kind != "standalone" else ():
                    sp = spec._replace(solvers=[
                        s.replace(n_steps=n, step_size=None, custom_grid=None)
                        for s in spec.solvers])
                    accs.append(regime_evaluators(model, sp, fgsm_cfg, dtype,
                                                  uk)[0](
                        iter(data), gen_of(clean_seed), []))
                got = port.launch_counts()
                want = Counter()
                for n in sweep if uk else ():
                    want += Counter({m: v * nb for m, v in
                                     forward_counts(kind, n).items()})
                if got != dict(want):
                    fail(f"{label} {spec.name} sweep: launches {got}, "
                         f"expected {dict(want)}")
                totals += Counter(got)
            med = lambda v: sorted(v)[len(v) // 2]
            row = dict(regime=spec.name, clean_kernel=sum(ck),
                       clean_plain=sum(cp), near_ties=ties,
                       fgsm_kernel=fk, fgsm_plain=fp,
                       n=nb * data[0][1].shape[0],
                       logit_err=max(errs), logit_bar=min(bars),
                       x_adv_differ=fa["differ"], x_adv_worst=worst,
                       input_grad_err=g_err, input_grad_far=g_far,
                       f64_x_adv_differ=f64["differ"],
                       f64_x_adv_worst=f64["worst"],
                       f64_input_grad_err=f64["grad_err"],
                       f64_input_grad_far=f64["grad_far"],
                       sweep=sweep, sweep_kernel=sweep_k, sweep_plain=sweep_p,
                       clean_ms=med(k["clean_ms"]), fgsm_ms=med(k["fgsm_ms"]),
                       plain_clean_ms=med(p["clean_ms"]),
                       plain_fgsm_ms=med(p["fgsm_ms"]))
            rows.append(row)
            print(f"  {spec.name:20s} clean {sum(ck)}/{row['n']} (plain "
                  f"{sum(cp)}; {ties} near-ties, {flips} other predictions "
                  f"apart), FGSM per batch {fk} (plain {fp}); logits "
                  f"max|diff| {row['logit_err']:.3e} (bar "
                  f"{row['logit_bar']:.3e}); x_adv (f32, batch "
                  f"{x.shape[0]}) differs at {row['x_adv_differ']} pixels "
                  f"({share:.2e}), largest |grad| there {worst:.2e} of the "
                  f"max; input grads max|diff| {g_err:.2e} of the max, "
                  f"{g_far:.2e} of them over 1e-3 of it; plain path f64 vs "
                  f"f32: x_adv {f64['differ']} pixels ({f64['share']:.2e}, "
                  f"largest |grad| {f64['worst']:.2e}), input grads "
                  f"{f64['grad_err']:.2e}, {f64['grad_far']:.2e} over 1e-3"
                  + (f"; sweep {list(sweep)}: {sweep_k} (plain {sweep_p})"
                     if sweep else ""), flush=True)
            print(f"  {spec.name:20s} ms per batch (median of {nb} after a "
                  f"warm-up): clean {row['clean_ms']:.3f} (plain "
                  f"{row['plain_clean_ms']:.3f}), FGSM {row['fgsm_ms']:.3f} "
                  f"(plain {row['plain_fgsm_ms']:.3f}); per batch clean "
                  f"{[round(m, 3) for m in k['clean_ms']]}, FGSM "
                  f"{[round(m, 3) for m in k['fgsm_ms']]}", flush=True)
            if flips or abs(sum(ck) - sum(cp)) > ties:
                fail(f"{label} {spec.name}: clean counts {sum(ck)} vs plain "
                     f"{sum(cp)}, {flips} predictions apart beyond the "
                     f"{ties} near-ties")
            if any(abs(a - b) > 2 for a, b in zip(fk, fp)):
                fail(f"{label} {spec.name}: FGSM counts {fk} vs plain {fp}")
            if any(e > b for e, b in zip(errs, bars)):
                fail(f"{label} {spec.name}: logits {errs} over bars {bars}")
            over = lambda v, bar: bar is not None and v > bar
            if share > 1e-3 or over(worst, x_adv_bar) \
                    or over(g_err, grad_bar) or over(g_far, far_bar):
                fail(f"{label} {spec.name}: x_adv differs at {share:.2e} of "
                     f"the pixels, where the input gradient is up to "
                     f"{worst:.2e} of its max (bar {x_adv_bar}); input "
                     f"gradients {g_err:.2e} of the max apart (bar "
                     f"{grad_bar}), {g_far:.2e} of them over 1e-3 of it "
                     f"(bar {far_bar})")
            if sweep_k != sweep_p:
                fail(f"{label} {spec.name}: sweep {sweep_k} vs plain "
                     f"{sweep_p}")
        return totals, rows

    phase(f"regimes: the Evaluate-notebook table on the MNIST MetaNODE (dim "
          f"{MNIST_DIM}, f32), clean and FGSM eps {MNIST_FGSM_EPS}, sn_test "
          f"over {SWEEP}, {EVAL_BATCHES} batches of {EVAL_BATCH}")
    mnist = build_model("mnist", dim=MNIST_DIM,
                        generator=torch.Generator().manual_seed(0))
    gen_cpu.manual_seed(13)
    mdata = [(torch.rand(EVAL_BATCH, 28, 28, 1, generator=gen_cpu).to(dev),
              torch.randint(0, 10, (EVAL_BATCH,), generator=gen_cpu).to(dev))
             for _ in range(EVAL_BATCHES)]
    s05 = create_solver("rk2", "u", n_steps=N_STEPS, u0=U)
    mgrid = notebook_regime_grid(s05, torch.Generator().manual_seed(15))
    print(f"  noised member u {float(mgrid[3].solvers[1].u):.6f}",
          flush=True)
    mnist_regime_counts, mnist_regime_rows = regime_table(
        "MNIST", mnist, mgrid, mdata,
        AttackConfig(mode="fgsm", eps=MNIST_FGSM_EPS), None,
        lambda lp: 1e-4 * max(1.0, lp.abs().max().item()),
        mnist_forward_counts, mnist_forward_counts,
        # ReLU masks at pre-activations within rounding of 0 flip between
        # two forwards that round apart (phase 11), so a sample's input
        # gradient can move by a share of the max and flip a sign well
        # above 1e-6 of it; the plain path in f64 against f32 shows how far
        # rounding alone moves them.  The bars are x_adv's share of pixels
        # apart (phase 11's) and the share of gradients apart by 1e-3
        x_adv_bar=None, grad_bar=None, far_bar=MNIST_GRAD_FAR_BAR,
        sweep=SWEEP)
    print("regime table MNIST f32: " + json.dumps(mnist_regime_rows),
          flush=True)
    del mnist, mdata
    torch.cuda.empty_cache()

    phase(f"regimes: the Evaluate-notebook table on premetanode10 (in_planes "
          f"64, bf16), clean and FGSM eps 8/255, {CIFAR_EVAL_BATCHES} batches "
          f"of {BATCH}")
    model = build_model("premetanode10", in_planes=64,
                        generator=torch.Generator().manual_seed(0))
    gen_cpu.manual_seed(14)
    cdata = [(normalize(torch.rand(BATCH, 32, 32, 3, generator=gen_cpu),
                        CIFAR10_MEAN, CIFAR10_STD).to(dev),
              torch.randint(0, 10, (BATCH,), generator=gen_cpu).to(dev))
             for _ in range(CIFAR_EVAL_BATCHES)]
    cgrid = notebook_regime_grid(s05, torch.Generator().manual_seed(55))
    cifar_regime_counts, cifar_regime_rows = regime_table(
        "premetanode10", model, cgrid, cdata,
        AttackConfig(mode="fgsm", eps=8 / 255, mean=CIFAR10_MEAN,
                     std=CIFAR10_STD), torch.bfloat16,
        lambda lp: 2.0 ** -5 * lp.abs().max().item(), cifar_forward_counts,
        lambda kind, n: cifar_forward_counts(kind, n, b2=False),
        x_adv_bar=1e-6, grad_bar=1e-4, far_bar=None)  # GELU has no
    # masks: phase 10's bars
    print("regime table premetanode10 bf16: "
          + json.dumps(cifar_regime_rows), flush=True)
    del model, cdata
    torch.cuda.empty_cache()

    # ------------------------------------------------- 15-17 the CLIs
    runner_counts = runner_phases(port, torch, dev, med, mnist_med)
    print(f"  launches over phases 15-17's runs: {dict(runner_counts)}",
          flush=True)

    # ------------------------------------------- 18-19 the CIFAR family
    gn_counts, gn_med, family_counts, (m18_counts, m18_ms, m18_peak) = \
        cifar_family_phases(port, torch, dev, med)
    print(f"  launches over phase 19's runs: {dict(family_counts)}",
          flush=True)

    # ----------------------------------- 21-22 adjoint and trainable u
    (adj_counts, adj_ms, adj_peak, solver_counts, solver_step_counts,
     solver_ms, solver_peak) = a18_phases(port, torch, dev, med, train_peak, mnist_med)

    # ------------------------------------------------- 23-25 the fleet
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    member_rows = member_launch_phase(port, torch, dev, time_ms, bound,
                                      randn)
    fleet = fleet_train_phases(port, torch, dev)
    fleet_cli = fleet_cli_phase(port, torch, dev)
    print(f"  launches over phase 25's runs: {fleet_cli['counts']}",
          flush=True)

    # ----------------------------------------- 26 export and load, serving
    cudnn.allow_tf32, matmul.allow_tf32 = tf32_defaults
    exported = export_phase(port, torch, dev)
    print(f"  launches over phase 26's loaded requests: "
          f"{exported['counts']}", flush=True)

    # --------------------------- 27 regime and backoff fleets, 28 examples
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    regime_fleet = regime_fleet_phase(port, torch, dev, fleet["step_ms"])
    print(f"  launches over phase 27's timed steps: "
          f"{regime_fleet['counts']}", flush=True)
    cudnn.allow_tf32, matmul.allow_tf32 = tf32_defaults
    examples = examples_phase(port, torch, dev)
    print(f"  launches over phase 28's examples: {examples['counts']}",
          flush=True)

    # ------------------- 29 the ensemble's member axis, 30 data parallelism
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    ens = ensemble_mesh_phase(port, torch, dev)
    print(f"  launches over phase 29's member-path batches: {ens['counts']}",
          flush=True)
    dp = dp_phase(port, torch, dev, ens, med)
    print(f"  launches over phase 30's data-parallel runs: {dp['counts']}; "
          f"its ensemble ranks: {dp['ensemble_counts']}", flush=True)

    # ----------------------------- 31 tensor, spatial, pipeline parallelism
    mesh_axes = mesh_axes_phase(port, torch, dev)
    print(f"  launches over phase 31's counted steps and evals: "
          f"{mesh_axes['counts']} ({mesh_axes['wall_s']:.1f} s)", flush=True)
    ens_rows = {k: v for k, v in ens.items()
                if k in ("mnist f32", "premetanode10 bf16")}

    # ------------------------------------------------------------- report
    def per_request_sums(rows, calls, dtype):
        """Sums over one request's calls; calls maps a row key to its
        launches per request."""
        by_key = {r["key"]: r for r in rows if r["dtype"] == dtype}
        picked = [(by_key[k], m) for k, m in calls.items()]
        ops_ms = sum(r["ops_ms"] * m for r, m in picked)
        bytes_ms = sum(r["bytes_ms"] * m for r, m in picked)
        libs = [r["library_ms"] for r, _ in picked]
        sums = {
            "max_abs_err": max(r["max_abs_err"] for r, _ in picked),
            "ms": sum(r["ms"] * m for r, m in picked),
            "plain_ms": sum(r["plain_ms"] * m for r, m in picked),
            "bound_ms": sum(r["bound_ms"] * m for r, m in picked),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": (None if None in libs else
                           sum(x * m for x, (_, m) in zip(libs, picked))),
        }
        if all("flops" in r for r, _ in picked):
            sums.update(rate(sum(r["flops"] * m for r, m in picked),
                             sums["ms"], sums["bound_ms"]))
        return sums

    def entry(name, source, replaces, sums, **extra):
        by_path = {
            "premetanode10 bf16": {"requests": cifar_requests,
                                   "launches": cifar_counts.get(name, 0)},
            "mnist f32": {"requests": mnist_requests,
                          "launches": mnist_counts.get(name, 0)},
            "flagship train bf16": {"steps": TRAIN_STEPS,
                                    "launches": train_counts.get(name, 0)},
            "mnist train f32": {
                "steps": TRAIN_STEPS,
                "launches": mnist_train_counts.get(name, 0)},
            "mnist eval f32": {"batches": 2 * EVAL_BATCHES,
                               "launches": eval_counts.get(name, 0)},
            "mnist regimes f32": {
                "launches": mnist_regime_counts.get(name, 0)},
            "premetanode10 regimes bf16": {
                "launches": cifar_regime_counts.get(name, 0)},
            "metanode10 GN train bf16": {"steps": TRAIN_STEPS,
                                         "launches": gn_counts.get(name, 0)},
            "metanode18 GN train bf16": {
                "steps": M18_TRAIN_STEPS,
                "launches": m18_counts.get(name, 0)},
            "cifar family runner bf16": {
                "launches": family_counts.get(name, 0)},
            "adjoint train bf16": {"steps": TRAIN_STEPS,
                                   "launches": adj_counts.get(name, 0)},
            "solver train runner f32": {
                "steps": SOLVER_EPOCHS * RUNNER_MNIST_STEPS,
                "launches": solver_counts.get(name, 0)},
            "fleet train f32": {"steps": TRAIN_STEPS,
                                "members": FLEET_S,
                                "launches": fleet["counts"].get(name, 0)},
            "fleet CLIs f32": {"launches": fleet_cli["counts"].get(name, 0)},
            "exported serving": {
                "requests": exported["requests"],
                "launches": exported["counts"].get(name, 0)},
            "regime fleet train f32": {
                "steps": TRAIN_STEPS * len(REGIME_FLEET_OPTIONS),
                "members": FLEET_S,
                "launches": regime_fleet["counts"].get(name, 0)},
            "examples": {"launches": examples["counts"].get(name, 0)},
            "ensemble_eval": {
                "batches": 2 * ENS_BATCHES * len(ens_rows),
                "launches": ens["counts"].get(name, 0)
                + dp["ensemble_counts"].get(name, 0)},
            "dp_train": {"launches": dp["counts"].get(name, 0)},
            **{f"{kind}_train": {
                "launches": mesh_axes["counts"][kind].get(name, 0)}
               for kind in ("tp", "sp", "pp")},
        }
        paths = {
            "adjoint_train_bf16": {
                "launches_per_step": {k: v // TRAIN_STEPS
                                      for k, v in adj_counts.items()},
                "step_ms": adj_ms, "peak_gib": adj_peak,
                "backprop_step_ms": med, "backprop_peak_gib": train_peak},
            "solver_train_f32": {
                "launches_per_step": solver_step_counts,
                "step_ms": solver_ms, "peak_gib": solver_peak,
                "frozen_u_step_ms": mnist_med},
            "fleet_train_f32": {
                k: fleet[k] for k in (
                    "members", "launches_per_step",
                    "single_launches_per_step", "step_ms",
                    "single_step_ms", "single_step_ms_x_members", "img_s",
                    "peak_gib", "chunk_sizes", "pgd_step_ms",
                    "member_vs_single", "witness_f32_vs_f64")},
            "exported_serving": exported["paths"],
            "regime_fleet_train_f32": {
                "regimes": regime_fleet["regimes"],
                "backoff": regime_fleet["backoff"]},
            "examples": {k: {f: v for f, v in r.items()
                             if f in ("clean_acc", "pgd_acc", "regimes",
                                      "u", "final_loss", "launches",
                                      "seconds", "wall_s")}
                         for k, r in examples["runs"].items()},
            "ensemble_eval": ens_rows,
            "dp_train": {k: dp[k] for k in ("a", "b", "c", "d",
                                             "wall_s_abd")},
            "mesh_train": {k: mesh_axes[k] for k in ("tp", "sp", "pp", "d",
                                                     "wall_s")},
        }
        return {"name": name, "route": "cuda", "op": OPS.get(name),
                "source": source, "replaces": replaces,
                "launches": sum(p["launches"] for p in by_path.values()),
                "by_path": by_path, **sums, **paths, **extra}

    def gelu_step_sums(way):
        """Phase 6c's bf16 rows of one way summed over a flagship train
        step's launches."""
        picked = [r for r in gelu["rows"]
                  if r["dtype"] == "bfloat16" and r["way"] == way]
        sums = {k: sum(r[k] * r["launches_per_train_step"] for r in picked)
                for k in ("ms", "plain_ms", "bound_ms")}
        return {**sums, "bound_by": "bytes",
                "bound_share": sums["bound_ms"] / sums["ms"],
                "ulps": max(r["ulps"] for r in picked),
                "launches_per_train_step": sum(
                    r["launches_per_train_step"] for r in picked)}

    b1_cifar = Counter(c[1:6] for c in B1_CALLS)
    b3_mnist = {c[1:6]: c[6] for c in B3_CALLS}
    b1_mnist = {c[1:6]: c[6] for c in B1_MNIST_CALLS}
    dgrad_rows = [r for r in bwd_rows if r["kind"] == "dgrad"]
    wgrad_rows = [r for r in bwd_rows if r["kind"] == "wgrad"]
    # a train step's B3 backwards: PGD_ITERS dx-only ones and one full one
    # for each GroupNorm of a pass
    b3b_step = {}
    for _, n, h, w, c, act, k in B3_BWD_CALLS:
        b3b_step[(n, h, w, c, act, "dx")] = PGD_ITERS * k
        b3b_step[(n, h, w, c, act, "full")] = k
    b1b_mnist = {TRAIN_MNIST: (PGD_ITERS + 1) * MNIST_B1_PER_PASS}
    # phase 18's step: two forward passes; the backward of the attack pass
    # is dx only, the training pass's gives dscale and dbias too
    b3_gn_step = {c[1:6]: 2 * c[6] for c in B3_CIFAR_CALLS}
    b3_m18_step = {c[1:6]: 2 * c[6] for c in B3_CIFAR_CALLS + B3_WIDE_CALLS}

    def bwd_step(calls):
        return {(n, h, w, c, act, kind_): k
                for _, n, h, w, c, act, k in calls for kind_ in ("dx", "full")}

    b3b_gn_step = bwd_step(B3_CIFAR_CALLS)
    b3b_m18_step = bwd_step(B3_CIFAR_CALLS + B3_WIDE_CALLS)

    def member_sums(name, calls):
        """Phase 23's member-batched rows of kernel ``name`` summed over a
        clean fleet step's launches (calls: row key -> launches a step)."""
        by_key = {r["key"]: r for r in member_rows if r["kernel"] == name}
        picked = [(by_key[k], m) for k, m in calls.items()]
        add = lambda f: sum(r[f] * m for r, m in picked)  # noqa: E731
        return {"members": FLEET_S,
                "rows": [r for r in member_rows if r["kernel"] == name],
                "launches_per_fleet_step": sum(m for _, m in picked),
                "max_abs_err": max(r["max_abs_err"] for r, _ in picked),
                "bit_equal_to_single_launches": all(
                    r["bit_equal"] for r, _ in picked),
                "ms": add("ms"), "singles_ms": add("singles_ms"),
                "plain_ms": add("plain_ms"), "library_ms": add("library_ms"),
                "bound_ms": add("bound_ms"),
                "bound_by": ("operations" if add("ops_ms") >= add("bytes_ms")
                             else "bytes")}

    fleet_b1 = {TRAIN_MNIST: fleet["launches_per_step"]["conv3x3_same"]}
    fleet_dgrad = {TRAIN_MNIST[:3] + (TRAIN_MNIST[4], TRAIN_MNIST[3]):
                   fleet["launches_per_step"]["conv3x3_dgrad"]}
    fleet_wgrad = {TRAIN_MNIST: fleet["launches_per_step"]["conv3x3_wgrad"]}
    fleet_b3 = {(FLEET_N,) + c[2:6]: c[6] for c in B3_CALLS}
    fleet_b3b = {(FLEET_N,) + c[2:6] + ("full",): c[6] for c in B3_CALLS}
    def mesh_rows(rows):
        """Phases 3-4's rows at phase 31's shapes, by dtype and shape."""
        return {f"{r['dtype']} {r['key']}": {
            k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "library_ms",
                              "bound_ms", "path", "plan") if k in r}
            for r in rows if r["key"] in MESH_SHAPES}

    kernels = [
        entry("conv3x3_same", "neural_ode_metasolver_tpu_torch/csrc/conv3x3.cu",
              "neural_ode_metasolver_tpu/ops/pallas_im2col.py:93",
              per_request_sums(b1_rows, b1_cifar, "bfloat16"),
              mnist_f32=per_request_sums(b1_rows, b1_mnist, "float32"),
              digits_f32=per_request_sums(b1_rows, {TRAIN_MNIST: 1},
                                          "float32"),
              train_step_bf16=per_request_sums(b1_rows, TRAIN_FWD,
                                               "bfloat16"),
              mnist_train_dgrad_f32=per_request_sums(
                  dgrad_rows, b1b_mnist, "float32"),
              dgrad={"launches": train_counts.get("conv3x3_dgrad", 0),
                     **per_request_sums(dgrad_rows, TRAIN_DGRAD,
                                        "bfloat16"),
                     "paths": {str(r["key"]): r["path"] for r in dgrad_rows
                               if r["dtype"] == "bfloat16"},
                     "members_f32": member_sums("conv3x3_dgrad",
                                                fleet_dgrad),
                     "tp_sp_pp_shapes": mesh_rows(dgrad_rows)},
              members_f32=member_sums("conv3x3_same", fleet_b1),
              tp_sp_pp_shapes=mesh_rows(b1_rows)),
        entry("conv3x3_wgrad",
              "neural_ode_metasolver_tpu_torch/csrc/conv3x3_wgrad.cu",
              "neural_ode_metasolver_tpu/ops/pallas_im2col.py:93",
              per_request_sums(wgrad_rows, TRAIN_WGRAD, "bfloat16"),
              f32=per_request_sums(wgrad_rows, TRAIN_WGRAD, "float32"),
              mnist_train_f32=per_request_sums(
                  wgrad_rows, {TRAIN_MNIST: MNIST_B1_PER_PASS}, "float32"),
              plans={str(r["key"]): r["plan"] for r in wgrad_rows
                     if r["dtype"] == "bfloat16"},
              members_f32=member_sums("conv3x3_wgrad", fleet_wgrad),
              tp_sp_pp_shapes=mesh_rows(wgrad_rows),
              note="not a TPU kernel: the backward of B1 that slice 3 "
                   "needs (the Pallas B1 has no VJP)"),
        entry("ode_block_rk2",
              "neural_ode_metasolver_tpu_torch/csrc/ode_block_rk2.cu",
              "neural_ode_metasolver_tpu/ops/pallas_ode_block.py:182",
              per_request_sums(b2_rows, Counter(c[1:] for c in B2_CALLS),
                               "bfloat16")),
        entry("group_norm_act",
              "neural_ode_metasolver_tpu_torch/csrc/group_norm_act.cu",
              "neural_ode_metasolver_tpu/ops/pallas_kernels.py:111",
              per_request_sums(b3_rows, b3_mnist, "float32"),
              bf16=per_request_sums(b3_rows, b3_mnist, "bfloat16"),
              metanode10_gn_train_bf16={
                  **per_request_sums(b3_rows, b3_gn_step, "bfloat16"),
                  "launches_per_step":
                      gn_counts.get("group_norm_act", 0) // TRAIN_STEPS},
              metanode18_gn_train_bf16={
                  **per_request_sums(b3_rows, b3_m18_step, "bfloat16"),
                  "launches_per_step": m18_counts.get(
                      "group_norm_act", 0) // M18_TRAIN_STEPS},
              members_f32=member_sums("group_norm_act", fleet_b3),
              launch_floor_ms=floor_ms),
        entry("group_norm_act_bwd",
              "neural_ode_metasolver_tpu_torch/csrc/group_norm_act_bwd.cu",
              "neural_ode_metasolver_tpu/ops/pallas_kernels.py:159 (the "
              "custom VJP _bwd of fused_group_norm_act: jnp in JAX, not "
              "Pallas)",
              per_request_sums(b3b_rows, b3b_step, "float32"),
              bf16=per_request_sums(b3b_rows, b3b_step, "bfloat16"),
              metanode10_gn_train_bf16={
                  **per_request_sums(b3b_rows, b3b_gn_step, "bfloat16"),
                  "launches_per_step":
                      gn_counts.get("group_norm_act_bwd", 0) // TRAIN_STEPS,
                  "full_launches_per_step": gn_counts.get(
                      "group_norm_act_bwd_params", 0) // TRAIN_STEPS},
              metanode18_gn_train_bf16={
                  **per_request_sums(b3b_rows, b3b_m18_step, "bfloat16"),
                  "launches_per_step": m18_counts.get(
                      "group_norm_act_bwd", 0) // M18_TRAIN_STEPS,
                  "full_launches_per_step": m18_counts.get(
                      "group_norm_act_bwd_params", 0) // M18_TRAIN_STEPS,
                  "step_ms": m18_ms, "peak_gib": m18_peak},
              full_launches=(
                  mnist_train_counts.get("group_norm_act_bwd_params", 0)
                  + gn_counts.get("group_norm_act_bwd_params", 0)
                  + m18_counts.get("group_norm_act_bwd_params", 0)),
              dx_only_launches=(
                  mnist_train_counts.get("group_norm_act_bwd", 0)
                  - mnist_train_counts.get("group_norm_act_bwd_params", 0)
                  + gn_counts.get("group_norm_act_bwd", 0)
                  - gn_counts.get("group_norm_act_bwd_params", 0)
                  + m18_counts.get("group_norm_act_bwd", 0)
                  - m18_counts.get("group_norm_act_bwd_params", 0)
                  + eval_counts.get("group_norm_act_bwd", 0)
                  + mnist_regime_counts.get("group_norm_act_bwd", 0)),
              plans={str(r["key"][:4]): r["plan"] for r in b3b_rows
                     if r["dtype"] == "float32" and r["key"][5] == "full"},
              members_f32=member_sums("group_norm_act_bwd", fleet_b3b)),
        entry("gelu_poly", "neural_ode_metasolver_tpu_torch/csrc/gelu_poly.cu",
              "none: XLA fused GeLUpoly (neural_ode_metasolver_tpu/models/"
              "nn.py::gelu_poly) into the code around it",
              gelu_step_sums("forward"), backward=gelu_step_sums("backward"),
              rows=gelu["rows"], host_us=gelu["host_us"]),
    ]
    units = ("launches: total over the counted requests of both served "
             "paths (by_path splits them); ms, plain_ms, bound_ms, "
             "library_ms: batch 256, summed over the launches of one "
             "request (tflops: their flops over ms; bound_share: bound_ms "
             "over ms): conv3x3_same and ode_block_rk2 of premetanode10 in "
             "bf16 (conv3x3_same's mnist_f32: of the MNIST MetaNODE in "
             "f32), group_norm_act of the MNIST MetaNODE in f32 (its bf16: "
             "the same calls in bf16; launch_floor_ms: one one-element add_ "
             "timed the same way), its library_ms F.group_norm plus "
             "torch.relu where the kernel fuses relu; max_abs_err: the "
             "largest of those calls.  The flagship train step (bf16, "
             "batch 256): conv3x3_same's train_step_bf16 sums its 136 "
             "forward launches a step, its dgrad (B1 on flipped weights, "
             "launches counted as conv3x3_dgrad) the 135 dgrad launches a "
             "step; conv3x3_wgrad's numbers sum its 68 launches a step "
             "(f32: the same calls in f32), its library_ms "
             "torch.nn.grad.conv2d_weight (dgrad: conv2d_input).  The "
             "digits train step (MNIST, f32, batch 128): conv3x3_same's "
             "mnist_train_dgrad_f32 and conv3x3_wgrad's mnist_train_f32 sum "
             "a step's 256 dgrad and 32 wgrad launches at (128, 6, 6, "
             "65 -> 64); group_norm_act_bwd's numbers sum a step's 408 "
             "backward launches (357 dx only, 51 with dscale and dbias) at "
             "the MNIST shapes in f32 (bf16: the same calls in bf16), its "
             "library_ms aten's native_group_norm_backward (after "
             "threshold_backward where the kernel fuses relu), its bound "
             "the bytes of x, dout and dx; by_path's mnist eval f32 counts "
             "the clean and the PGD evaluation's batches, its regimes paths "
             "the kernel path's launches of phases 13 and 14 (each regime's "
             "clean and FGSM batches, and MNIST's step-count sweep).  "
             "metanode10_gn_train_bf16 (group_norm_act and "
             "group_norm_act_bwd): phase 18's metanode10-GN train step in "
             "bf16 at batch 256, summed over a step's 140 forward launches "
             "at the CIFAR shapes (32 groups, GELU fused or none; library_ms "
             "F.group_norm then F.gelu) and its 140 backward launches (70 dx "
             "only, 70 with dscale and dbias; library_ms aten's GN backward "
             "after gelu_backward); by_path's metanode10 GN train bf16 "
             "counts phase 18's timed steps, its cifar family runner bf16 "
             "phase 19's first cifar_runner run and its kernel-path eval "
             "batches.  metanode18_gn_train_bf16: the same for phase 20's "
             "metanode18-GN step (280 forward and 280 backward launches a "
             "step, the wide rows included; step_ms its counted step, "
             "peak_gib its peak memory), by_path's metanode18 GN train bf16 "
             "its counted step.  adjoint_train_bf16 (every kernel): phase "
             "21's flagship step under the continuous adjoint (launches a "
             "step of every kernel, median step_ms and peak_gib beside "
             "phase 9's backprop step's), by_path's adjoint train bf16 its "
             "timed steps; solver_train_f32: phase 22's mnist_runner "
             "--train_solver_params (launches a step, the second epoch's "
             "batch_time as step_ms, the run's peak_gib, phase 11's "
             "frozen-u step beside), by_path's solver train runner f32 the "
             "whole run, validation included.  fleet_train_f32 (every "
             "kernel): phase 24's u-sweep step as one fleet of 16 members "
             "(MNIST dim 64, batch 128 a member, f32, clean): launches a "
             "fleet step and a single-run step, median step_ms against "
             "single_step_ms x members, img/s over all members, peak_gib, "
             "chunk_sizes (step ms, img/s and peak at 1, 4, 8, 16, 32 "
             "members), the members against their single runs and the f32 "
             "vs f64 witness; by_path's fleet train f32 its timed steps, "
             "fleet CLIs f32 phase 25's u_sweep and sweep runs.  "
             "members_f32 (conv3x3_same, its dgrad, conv3x3_wgrad, "
             "group_norm_act, group_norm_act_bwd): phase 23's member-"
             "batched launches at 16 members of 128 images, each row bit-"
             "equal to 16 single launches (rows: one launch's ms, "
             "singles_ms for 16 single launches, the plain version, the "
             "library: cuDNN's grouped conv2d / conv2d_input / "
             "conv2d_weight with groups=16, F.group_norm on the 2048 "
             "samples then the members' affine and relu, aten's GN "
             "backward so composed), summed over a clean fleet step's "
             "launches (launches_per_fleet_step).  op: the kernel's "
             "torch.library custom op (ops/library.py), through which an "
             "exported program launches it (null: training only, no op).  "
             "exported_serving: phase 26's artifacts (MNIST f32, "
             "premetanode10 bf16; exported on the card, MNIST on the CPU "
             "too): export_s, artifact_mb, the graph's nodems ops, and in "
             "the loading process load_s and per batch size the median ms "
             "and img/s of 5 requests beside the live ServedModel's, the "
             "logits' max_abs_err and bar, bit_equal, launches_a_request; "
             "by_path's exported serving counts the loading process's "
             "requests on the card.  regime_fleet_train_f32 (every "
             "kernel): phase 27's fleet of 16 under switch[0.6,0.4] and "
             "solver_ens[0.6,0.4] (launches a step against a single "
             "step's whose draws take the same branches, median step_ms "
             "beside phase 24's standalone fleet, the members' step-1 "
             "training draws, the members against their single runs, the "
             "kernel path against the plain path) and the Adam "
             "nan_backoff fleet (each member's count, scale, n_skipped "
             "beside its single run's, params apart); by_path's regime "
             "fleet train f32 its timed steps.  examples: phase 28's "
             "examples/torch scripts on the card (accuracies, u, their "
             "own launches and seconds, wall_s of the subprocess); "
             "by_path's examples their launches.  ensemble_eval: phase "
             "29's four noised members on the member axis (a one-rank "
             "ensemble mesh) beside the member loop, MNIST f32 and "
             "premetanode10 bf16, two batches of 256 each: probabilities "
             "apart, accuracies, ms a batch and launches a batch both ways; "
             "by_path's ensemble_eval the member path's counted batches and "
             "phase 30 (d)'s two ranks.  dp_train: phase 30's data "
             "parallelism: (a) mnist_runner --mesh data=1 on a one-rank "
             "NCCL group against no mesh, (b) two gloo ranks sharing the "
             "card against one process, (c) the flagship step as two ranks "
             "of 128 (the f32 reduced gradient's error and bar, bf16 ms a "
             "step and the all-reduce's ms a step per rank beside one "
             "process), (d) ensemble=2 against phase 29's one rank; "
             "by_path's dp_train the launches of (a)'s and (b)'s mesh runs "
             "and (c)'s timed steps, every rank.  mesh_train: phase 31's "
             "flagship recipe over data=1,model=2 (tp), data=1,sp=2 (sp) and "
             "data=1,pp=2 at M=2 and M=4 (pp), two gloo ranks against one "
             "process (two f32 steps: losses, step rels, params apart, "
             "launches a step a rank and the expected ones; one timed bf16 "
             "step ms a rank beside one process's), pp's switch and B2 "
             "evals, (d) cifar_runner --mesh data=1,pp=2 and its resume; "
             "by_path's tp_train, sp_train and pp_train the launches of "
             "those counted f32 steps (both ranks), pp's evals and (d)'s "
             "runs.  tp_sp_pp_shapes: phases 3-4's rows at the shapes "
             "those axes give the kernels.  gelu_poly: phase 6c's bf16 "
             "rows summed over a flagship train step's 138 launches each "
             "way (backward: gelu_poly_bwd), its plain_ms the composition "
             "(backward: autograd's backward of it), its bound the bytes "
             "of x and y (backward: x, the gradient and dx), ulps the "
             "largest distance to the plain version (bf16 ulps); rows: "
             "each shape, dtype and way; host_us: host microseconds a "
             "call, kernel and composition")
    for k in kernels:
        k["units"] = units
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:  # phase 30's subprocesses
        sys.exit(worker(sys.argv[2:]))
    sys.exit(main())
