#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It drives the
port's serving and training paths (``localregneuralde_tpu_torch``, no JAX)
on the card:

1. builds the CUDA kernels from ``localregneuralde_tpu_torch/csrc`` and
   prints the card's name and power limit;
2. holds each forward kernel against its plain PyTorch version at the
   slice's shapes (B = 512, F = 784, H = 100) and times both;
3. checks that the persistent solve is deterministic;
4. runs ``experiments/mnist_ode/mlp.yaml`` through ``construct_model`` →
   ``make_eval_step`` on synthetic MNIST batches at the config's tolerance
   and at the bench tolerance, counts the kernel launches of that run, and
   holds the logits against the plain path on the card and on the CPU;
5. holds the backward kernels (the step VJP, the knot recording of the
   persistent solve, the dense and the two-level sweep) against their plain
   versions, checks that the two-level replay repeats the forward bitwise,
   times them (kernel 8 both replay-forced and on its dense branch at the
   ``mlp.yaml`` knots, as the train step runs it), and holds both sweeps,
   beside the FP32 plain sweep, against the plain sweep in float64 on the
   same knots;
6. trains the same config with ``--model.regularize=unbiased`` through
   ``construct_optimizer`` → ``make_train_step`` for a few Adam steps at
   both tolerances, counts the kernel launches per step, and holds the
   first step's gradients against the plain path on the card and on the
   CPU;
7. holds the SDE kernels against their plain versions at the MNIST-SDE
   width (B = 512, F = 32, H = 64) and the ``mlp.yaml`` tolerance: the
   persistent SRI solve with its Brownian tree (states, step counts, knots
   that reconstruct their steps, determinism, the increments' moments) and
   the stored-adjoint sweep on its knots, and checks the reservoir sample of
   the persistent Tsit5 solve;
8. serves ``experiments/mnist_sde/mlp.yaml`` through ``make_eval_step``
   (three batches of 512) and trains it with ``--model.regularize=unbiased``
   and ``=biased`` through ``make_train_step``, with launch counts per step
   and the first step's cross-entropy gradients against the plain path;
9. takes one biased training step of the ODE at rtol 1e-4 through the
   persistent solve with its reservoir;
10. holds the Dense-chain kernels of the PhysioNet latent ODE against their
    plain versions at its full width (B = 512, F = 20, eight layers 20 <-> 40,
    the 49-point grid and t1 as saveat, from the encoder's latent states):
    the persistent solve at rtol 1e-4 and at the config's 1.4e-8, its knots,
    and the dense and the two-level sweep on its own knots (the replay
    bitwise the forward), with determinism, the sweep's weight gradients
    against the float64 plain sweep, the kernels' grids, and times (the
    solve alone at the training, eval and rtol 1e-4 shapes; the sweep's two
    branches);
11. trains ``experiments/physionet/physionet.yaml`` as shipped for three
    steps and evaluates the 410-series test split through the port's
    ``run_latent_ode_experiment``, with launches per step and per eval
    batch, and holds the first step's gradients against the plain path on
    the card and the eval MSE against the CPU;
12. holds the conv kernels of the CIFAR-10 Neural ODE (the Tsit5 step and
    its VJP) against their plain versions at ``experiments/cifar10/cnn.yaml``'s
    full width (B = 32, 32x32, 8 and 64 channels), from a state made by the
    model's own augmenter and BatchNorm: the step in training mode, in eval
    mode with the running stats and with batch statistics, the VJP, both
    bitwise deterministic, and the plain step in FP32 against FP64;
13. serves ``cnn.yaml`` as shipped (its ``'auto'`` takes the TF32 tier at
    its rtol 1e-4) through ``make_eval_step`` (three batches of 32)
    and trains it for three steps per arm (``regularize`` none and unbiased)
    through ``make_train_step``, with launches per batch and step (and by
    tier), and holds the first step's gradients and BatchNorm state against
    the plain path on the card at the same tiers (each step-kernel call's
    EMA chain against the plain step's at its tier, and each VJP-kernel call
    of the sweep against the plain VJP at its tiers, or with FP32 products
    against the FP64 one on the same knots) and the logits of four images
    against the CPU at the card's tiers;
14. holds the score samplers' kernels against their plain versions at the
    score demo's width (B = 4096, F = 2, TDChain 2 -> 64 -> 64 -> 2, random
    weights from seed 0): the reverse VP-SDE solve (kernel 11, SOSRI at
    rtol = atol = 1e-2) step for step on the same Philox path, the
    probability-flow solve (kernel 6, rtol 1e-4, atol 1e-6) within one
    accept, both bitwise repeatable, and the analytic N(0, I) cases of
    s(x, t) = -x;
15. draws three batches of 4096 samples each through ``sample_vpsde`` and
    ``sample_probability_flow`` (one kernel launch per draw, nothing else),
    with ms, samples/s and NFE, and a batch of 256 against the CPU;
16. holds kernel 15, the conv-orientation probe's tap and im2col layouts
    on the tensor cores (3xTF32 ``wgmma``), against cuDNN in FP32 at (32,
    32, 32, 64) and against a float64 conv (within twice the first port's
    error), bitwise repeatable and against its digests, and times both
    beside the conv GEMM core's forward and cuDNN, with a clocked split by
    phase and its probe variants (``[conv orient ...]``);
17. trains ``mlp.yaml`` and the bench tolerance (unbiased), the MNIST SDE
    (unbiased), PhysioNet as shipped and CIFAR-10 (unbiased) through the
    K-step train call (``make_multi_train_step``, K = auto = 5): one call
    against five ``make_train_step`` calls from a copy of the same state,
    bitwise (a CUDA-graph replay on every path but CIFAR, whose call is
    eager; its convs take cuDNN's deterministic algorithms inside the port,
    no flag is set here, and two eager runs are held bitwise too), the
    port kernels of one replay against the eager steps'
    (``torch.profiler``), ms a step both ways and the replay's busy share,
    and one captured call with ``grad_accumulation=2`` and
    ``ema_decay=0.999`` (``[capture ...]``, ``--only=capture``);
18. drives the remaining solver modes at full width (``--only=modes``):
    ``[modes ode ...]`` on ``mlp.yaml``'s model, the direct,
    interpolating and backsolve adjoints and VCAB3/VCABM3 at the bench
    tolerance, the direct adjoint at rtol 1.4e-8 and bfloat16 dynamics,
    each with ms a step and K1/K2/K3 launches a step (``torch.profiler``),
    its kernel route against its plain route and the direct adjoint
    against the stored one; ``[modes sde ...]`` on the MNIST SDE with
    Milstein, matrix Milstein (``sde_noise_dims = 3``), Euler–Heun and
    SOSRI under the direct adjoint; ``[modes score ...]``, the VP-SDE
    sampler with Milstein and Euler–Heun against an SOSRI draw; and
    ``[cifar repeat]``, two eager CIFAR runs and the K-step call bitwise
    equal with no process-wide flag;
19. the TD-MLP family at the TF32 'default' tier (``--only=tf32``,
    ``[tf32 ...]``): kernels 1, 2, 4, 3, 7 and 8 at TF32 against their
    TF32 plain versions (kernels 1, 2 and 3: the tensor cores' truncated
    sums, ``tf32_sum_tol``; kernel 4: one evaluation's TF32 rounding;
    kernels 7 and 8: twice the distance between the plain version on the
    card and on the CPU, ``against_plains``) and against FP32 across tiers
    (``tf32_tol`` of one evaluation or one step), their digests, kernel 4's
    refusal below rtol 1e-4, the forced TF32 replay bitwise its forward;
    the bench configuration's serving batches and train steps through
    'auto' (TF32) and 'highest' (FP32), each against the CPU at the card's
    tiers (``nn.tiers_of``), and mlp.yaml's train step with grad_precision
    'match' and 'default' against the card's FP32 plain route and the CPU
    at the card's tiers, each with launches by tier; with ``--only=tf32``
    also the K-step capture of both paths. The model routes' TF32 gates
    (``logits_tol``, ``grads_tol``) bound one evaluation or one swept step,
    never their sum; the serving and training phases (4 and 6) hold the
    card against the CPU at the card's tiers too. Then the conv family at
    TF32 (``[tf32 conv ...]``): kernel 13 in its three modes and kernel 14
    at both of its routes' tiers (TF32 throughout; FP32 recompute with TF32
    gradients) as accurate against float64 as their TF32 plain versions
    (``as_accurate``) and against FP32 across tiers, bitwise
    repeatable, their five digests, device times beside the FP32
    instantiations; the conv core's orientations at TF32 against cuDNN FP32
    on rounded operands, timed beside the FFMA core and cuDNN's own TF32
    (``{"conv_core_tf32": [...]}``); ``cnn.yaml``'s serving batch and a
    ``none`` and an ``unbiased`` train step through ``'auto'`` and
    ``'highest'``, each against the CPU at the card's tiers, with launches
    by tier; with ``--only=tf32`` also ``[capture cifar]`` and ``[cifar
    repeat]`` (bitwise at TF32). Then the SDE family at TF32 (``[tf32 sde
    ...]``, also ``--only=tf32_sde``): kernel 10 against its TF32 plain
    version on the same Philox path (each recorded step as accurate against
    its float64 step as the TF32 plain step) and kernel 12 at both of its
    routes' tiers on kernel 10's knots (``as_accurate``, and within one
    swept step's TF32 rounding of FP32), bitwise repeatable, their five
    digests, device times beside the FP32 instantiations; mnist_sde's
    serving batch and an ``unbiased`` train step through 'auto' (TF32) and
    'highest' (FP32 forwards, TF32 gradients), each against the CPU at the
    card's tiers, with launches by tier; and ``[capture mnist_sde]`` at
    TF32. Then the score family (``[tf32 score ...]``, also
    ``--only=tf32_score``): kernels 11 and 6 at TF32 against their TF32
    plain versions and as accurate against float64, their digests and
    times beside the FP32 instantiations, the refusal below rtol 1e-4, and
    the samplers' draws (``[score sample ...]``, kernels 11 and 6 at the
    backend default) against the CPU at the card's tiers; and the chain
    family (``[tf32 chain ...]``, ``[tf32 latent ...]``, also
    ``--only=tf32_chain``): kernel 5 at TF32 at rtol 1e-4, kernel 9 at
    tiers 2 (physionet.yaml's route) and TF32 throughout, dense and
    two-level (its replay kernel 5's TF32 attempt, bitwise the forward's
    knots), their digests and times; PhysioNet at 'auto' and a 'default'
    arm at rtol 1e-4 with the two-level replay forced, a training forward
    and backward and an eval batch each with launches by tier, against the
    CPU at the card's tiers; and ``[capture physionet]``. The layers
    outside the DE layers (the classifiers, the MNIST SDE's downsample,
    CIFAR's augmenter, the latent model's encoder, rec_to_gen and
    gen_to_data) compute at the backend default, TF32 on the card, so
    every model route's logits gate counts their TF32 rounding
    (``logits_tol``); the kernel checks whose inputs those layers make
    take them at FP32 (``nn.tiers_of("cpu")``), as their digests were
    taken. Kernel 9's TF32 gates hold every output on each of four
    cotangent seeds (``k9_accuracy``);
20. exports through ``utils/export.py`` (``[export ...]``, also
    ``--only=export``): ``mlp.yaml``'s classifier at B = 512 at rtol
    1.4e-8 (kernel 4 FP32) and 1e-4 'auto' (kernel 4 at TF32), the MNIST
    SDE frozen and threaded (kernel 10 at TF32), a probability-flow draw
    of the score demo's network (kernel 6 at TF32) and a ladder of B = 512
    and 1024 served 700 rows; ``physionet.yaml``'s latent ODE on the
    410-series eval batch at rtol 1.4e-8 (kernel 5 FP32) and 1e-4
    'default' (kernel 5 at TF32, ``[export latent ...]``) and ``cnn.yaml``
    at B = 32 at 'auto' (kernel 13 at TF32), 'highest' (FP32), on batch
    statistics and as a B = 32/64 ladder served 40 images (``[export
    cifar ...]``); loads every artifact through ``load_exported`` in one
    fresh process that imports no model code (none of ``models/``,
    ``harness/``), holds each ``torch.equal`` to the live model (NFE
    included), its device kernels under ``torch.profiler`` against the
    live call's (the solve's kernel once, kernel 13's every attempt, no
    plain version's loop) and prints ms a call both ways; then
    the phase probes (``[export probes]``): a captured bench training run
    through ``run_classification_experiment`` with finite fwd/bwd/opt
    columns, bitwise the run without probes;
21. data parallelism (``parallel/``, ``[dp ...]``, also ``--only=dp``) at
    ``mlp.yaml``'s full width with the regulariser on: world 1 over NCCL
    in this process (the per-rank step bitwise the single-device step, the
    global-grid step bitwise the non-persistent kernel route's, kernels 2
    and 3); world 2 over Gloo as two processes on this card (this script
    with ``--dp-worker``): the per-rank step bitwise the two half-batch
    steps averaged, the global grid at 'highest' rtol 1e-4 against the
    single-device step (NFE within 12, loss within ``DP_LOSS_RTOL``,
    gradients within ``DP_GRAD_REL`` of the largest), its 'auto' tier and
    ``mlp.yaml``'s rtol printed, each rank's kernels under
    ``torch.profiler`` (kernels 4 and 8, or 2 and 3, and no GEMM beyond
    the single-device route's: no plain version), ms a DP step beside the
    single-device step with the all-reduce's share; then both runners
    (``mlp.yaml``, ``physionet.yaml``) for a few steps on two ranks:
    rc 0, equal windows, rank 0's checkpoint. The global grid of the chain
    and SDE families (``[dp world1|world2 physionet|mnist_sde|
    mnist_sde_reg]``) at ``physionet.yaml``'s and ``mnist_sde/mlp.yaml``'s
    full width, B = 512, the last with its unbiased regulariser on (weight
    1000): kernels 5 and 10 solve the whole batch on every rank, kernels 9
    and 12 sweep the rank's rows. World 1 bitwise the single-device
    shipped route's loss and NFE; world 1 and both world-2 ranks against
    it (NFE equal, loss and gradients within ``DP_LOSS_RTOL`` and
    ``DP_GRAD_REL``, the latent model's with the regulariser's weight at
    0, its error estimate being float32 noise at rtol 1.4e-8); the solve
    and the sweep launched once a step, no plain sweep run, each rank's
    profile with both kernels, kernel 9 and 12 on the step's own knots
    held against their plain versions, ms a DP step beside the
    single-device step with the all-reduce's share; then both runners
    under ``'gspmd'`` (``physionet.yaml``, ``mnist_sde/mlp.yaml``) on two
    ranks. The conv family (``[dp world1|world2 cifar]``) at ``cnn.yaml``'s
    full width, B = 32, ``unbiased`` at its weight 2.5, at 'highest':
    kernel 13 on every attempt and kernel 14 on every accepted step (and
    the regulariser's step), both on the whole batch on every rank; world 1
    bitwise the single-device shipped route in loss, NFE, gradients and
    running stats, and at its tier-wise launch counts; world 2 NFE within
    12, loss and gradients within ``DP_LOSS_RTOL`` and ``DP_GRAD_REL``, no
    plain conv step, each rank's profile with both kernels; 'auto' (TF32)
    printed with its NFE beside the single device's; the classification
    runner under ``'gspmd'`` with ``cnn.yaml`` on two ranks.

Beside those: each persistent kernel's outputs (kernels 4 at both
tolerances, 5, 6, 8's replay and its gradients, 9, 10, 11 and 12, and
kernels 1, 2, 13, 14 and 15) are hashed with SHA-256 and held against
``DIGESTS``, the digests of the kernels before their redesign for the H100
(or, where a redesign changed a sum's order on purpose, after it), so a
kernel change that keeps them is bitwise the old kernel;
kernels 13 and 14 are split by kernel with ``torch.profiler``, and kernel
13's launch sequence by role in training and in eval with the running stats
(``[conv attribution ...]``: its conv1, conv2, conv3, bn_act, stage, time
maps and the gaps between launches); kernel 13's BatchNorm statistics are
held against float64 statistics of the same z (``[conv stats fp64]``) and
kernel 12's weight gradients against the float64 plain sweep (``[sde sweep
fp64]``), each within twice the error of the kernel before its Hopper
redesign; kernel 12's step is split into its phases by an instantiation
with a compile-time clock (``[sde sweep attribution]``); the conv GEMM
core of kernels 13 and 14 is timed alone in each orientation (forward, data
and weight gradient at N = 64 and N = 8, the thin ones on the halo tile
and held bitwise against the gather tile, and the forward with the
statistics epilogue level by level) in TFLOP/s beside cuDNN in FP32
(``[conv core]``, a ``{"conv_core": [...]}`` line); and kernel 11's
attempt, kernel 4's attempt, kernel 7's (and 8's) transposed step, kernel
5's attempt, kernel 9's step, kernel 10's attempt and kernel 6's attempt
are split into their phases by instantiations with a compile-time clock
(``[vpsde attribution]``, ``[solve attribution]``, ``[sweep
attribution]``, ``[chain solve attribution]``, ``[chain sweep
attribution]``, ``[sde solve attribution]``, ``[pf solve attribution]``),
kernel 6 runs in each layout of its probe (``[pf probe]``), kernel 4's
first attempt is held bitwise against kernels 1 and 2 on the same state
(``[solve cluster]``), kernel 2's step is split into its phases
(``[tdmlp attribution]``) and both kernels' grids are timed (``[tdmlp
probe]``), and kernels
10 and 11 print their bound with and without the Brownian tree's draws
(the kernels line takes the one with them); kernel 3 is held against
the float64 VJP beside the FP32 plain one (``[step_bwd fp64]``), and
kernel 9's weight gradients against the float64 plain sweep (``[chain
sweep fp64]``), each within twice the error of the kernel before its
redesign.

``--only=PART[,PART...]`` runs the kernel checks, digests and timings of
some parts (``PARTS``: kernels, backward, sde, chain, conv, conv_core,
score, attribution, orient, solve) without the model paths, and prints
neither the kernels line nor the ok line; ``ode`` adds the MNIST ODE's
serving and training paths (``[slice ...]``, ``[train ...]``) and
``latent`` the latent runner's (``[latent ...]``), ``sde_train`` the
MNIST-SDE train steps (``[sde train ...]``), ``cifar`` the CIFAR-10
serving and training paths (``[cifar ...]``), ``capture`` the K-step
train calls (``[capture ...]``), ``tf32_sde`` the SDE family's TF32 tier
(``[tf32 sde ...]`` and ``[capture mnist_sde]``), ``tf32_score`` the score
family's (``[tf32 score ...]`` and ``[score sample ...]``), ``tf32_chain``
the chain family's (``[tf32 chain ...]``, ``[tf32 latent ...]`` and
``[capture physionet]``), ``export`` the serving export and the phase
probes (``[export ...]``), ``dp`` data parallelism (``[dp ...]``) and
``tf32`` the TF32 tier whole (``[tf32 ...]``, ``[tf32 conv ...]``, ``[tf32 sde ...]``, the score and chain
families', the capture of the TD-MLP, MNIST-SDE, PhysioNet and CIFAR
paths and ``[cifar repeat]``).

``--profile`` adds a ``torch.profiler`` breakdown of the train steps by
kernel, the ``mlp.yaml`` serving batch by part (``[profile serve]``), the
latent encoder's share of the latent train step, and the CIFAR train
step's kernels.

The last line is ``{"ok": true, "device": {...}}``; the line before it
lists every kernel with its launches, error, times and bound (every
family's at each tier: FP32 and ``_tf32`` rows, kernels 3, 7, 8, 9, 12
and 14 by their tiers, launches by tier from the paths).
A bound is
the larger of the kernel's product FLOPs (counted from its shapes and this
run's step counts) over the H100's 67 TFLOP/s FP32 or 495 TFLOP/s TF32,
each product at its tier's peak, and the bytes it must move (each input
read once, each output written once) over 3.35 TB/s;
for kernels 10 and 11 the FP32 and INT32 work of the tree's draws counts
too (``tree_bound``). Any
failed check exits non-zero without that line, as does a machine without a
CUDA device.
"""
import contextlib
import functools
import gc
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

B, F, H = 512, 784, 100
CONFIG = "experiments/mnist_ode/mlp.yaml"
SDE_CONFIG = "experiments/mnist_sde/mlp.yaml"
SDE_TOL = 0.14  # the rtol = atol of SDE_CONFIG
BENCH = ["--model.solver.reltol=1e-4", "--model.solver.abstol=1e-4",
         "--model.solver.max_steps=64"]
TOLERANCES = (("mlp.yaml", []), ("bench", BENCH))
N_BATCHES = 3
TRAIN_STEPS = 5
LATENT_CONFIG = "experiments/physionet/physionet.yaml"
LATENT_TOL = 1.4e-8  # the rtol = atol of LATENT_CONFIG
LATENT_STEPS = 3
CIFAR_CONFIG = "experiments/cifar10/cnn.yaml"
CIFAR_BATCHES = 3  # eval batches of 32
CIFAR_STEPS = 3    # train steps per arm
# NVIDIA H100 SXM, dense (NVIDIA's data sheet): FP32 outside the tensor
# cores, TF32 on them, and HBM3
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12


def bound(flops, nbytes, peak=PEAK_FP32):
    """The least time the card could take for work of ``flops`` operations
    at ``peak`` (FP32 by default) that must move ``nbytes`` bytes: the
    larger of the two times at the card's peaks, and which one it is."""
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)


# The Brownian tree of kernels 10 and 11 as work of the card's own pipes
# (Hopper SM: 128 FP32 lanes and 64 INT32 lanes a clock; PEAK_FP32 counts
# an FFMA as two operations, so 33.5 T FP32 instructions/s and 16.7 T
# 32-bit integer multiplies/s at the same clock). A draw of
# sde.cuh::pair_normals is one Philox4x32-10 (two 32x32 -> 64 multiplies a
# round: 20) and four inverse CDFs (counted at their central branch: 28
# FP32 instructions each, the division as one, with the uniform's scaling);
# the bridge's midpoint of four channels adds 16 a draw.
PEAK_FP32_INSTR = PEAK_FP32 / 2
PEAK_INT32_MUL = PEAK_FP32 / 4
PHILOX_MULS = 20
TREE_FP32 = 4 * 28 + 16


def tree_bound(draws, flops, nbytes, peak=PEAK_FP32):
    """``bound`` with the Brownian tree's work counted beside the products:
    ``draws`` Philox draws, their integer multiplies on the INT32 pipe and
    their inverse CDFs on the FP32 pipe with the products' ``flops`` (at
    ``peak``: FP32's, or TF32's on the tensor cores beside the FP32 pipe);
    the largest of the pipes' times and the bytes' time."""
    t_int = draws * PHILOX_MULS / PEAK_INT32_MUL
    t_tree = draws * TREE_FP32 / PEAK_FP32_INSTR
    t_fp = (flops / PEAK_FP32 + t_tree if peak == PEAK_FP32
            else max(flops / peak, t_tree))
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_int, t_fp, t_bytes),
                bound_by="operations" if max(t_int, t_fp) >= t_bytes
                else "bytes", library_ms=None)


def mixed_bound(fp32_flops, tf32_flops, nbytes):
    """``bound`` of a launch whose products mix tiers: each product's FLOPs
    at its own tier's peak (FP32 outside the tensor cores, TF32 on them)."""
    t_ops = fp32_flops / PEAK_FP32 + tf32_flops / PEAK_TF32
    t_bytes = nbytes / PEAK_BYTES
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                library_ms=None)


# TF32's unit roundoff: cvt.rna rounds an operand to 10 mantissa bits, a
# relative error of at most 2^-11
U_TF32 = 2.0 ** -11


def tf32_tol(depth):
    """The tolerance of a comparison across tiers (a TF32 result against an
    FP32 one), relative to the FP32 result's largest value: each product
    rounds both its operands by at most 2^-11, so to first order an output
    that passes through ``depth`` products in sequence moves by at most
    2·2^-11·depth of its scale."""
    return 2 * U_TF32 * depth


def tf32_sum_tol(depth, k=F + 1):
    """The tolerance of a TF32 kernel against its TF32 plain version,
    relative to the output's largest value. Both round the same operands
    and their products are exact in FP32; only the FP32 sums differ, and the
    tensor cores round theirs toward zero (PR 14), a bias: a product of K
    terms moves by up to K·2^-24 of its scale (K = F + 1, the longest), and
    ``depth`` products in sequence add up."""
    return depth * k * 2.0 ** -24


# The model routes' gates. An FP32 route against an FP32 one keeps the FP32
# gates: logits 1e-4 max-abs, the cross-entropy 1e-4, gradients 1e-3
# relative. Where TF32 products enter, two routes part by TF32's rounding
# even at the same tiers: TF32 rounds every operand again after each sum,
# so two FP32 sum orders of one TF32 computation flip roundings (the plain
# sweep on the card and on the CPU, ``against_plains``), and the solve's
# step controller reads TF32's noise in ũ, so the routes' steps differ
# (kernel 4 and its TF32 loop on the same inputs: ys ~3e-4 apart at equal
# NFE). So a TF32 gate is TF32's rounding over one evaluation or one swept
# step, never summed over them: the state is a dt-weighted sum of
# evaluations (Σ dt = T), so it moves by one evaluation's rounding, and a
# weight gradient is a sum of the swept steps' contributions, each moved
# by one transposed step's. The cross-entropy, a mean over the batch,
# keeps 1e-4.
CE_TOL = 1e-4
EVAL_PRODUCTS = 2        # the products of one dynamics evaluation
# The layers outside the DE layers take the reference's precision=None, the
# backend default: TF32 on the card (and on the CPU at the card's tiers),
# whatever the solver's tier. Their products on the logits' path: the MNIST
# ODE's classifier; CIFAR's augmenter conv, classifier conv and Dense; the
# MNIST SDE's downsample and classifier
OUTER_PRODUCTS = 1
GRAD_PRODUCTS = 13       # the cotangent and weight-gradient products of one
                         # transposed step
STEP_BWD_PRODUCTS = 27   # those and the stage recompute's 14
# the conv family's (kernels 13 and 14): three convs an evaluation, six
# evaluations a step; a transposed step's reverse chain (three data-gradient
# products an evaluation and a weight gradient's) and with its recompute
CONV_EVAL_PRODUCTS = 3
CONV_STEP_PRODUCTS = 18
CONV_GRAD_PRODUCTS = 19
CONV_STEP_BWD_PRODUCTS = 37
CONV_DEPTHS = dict(eval_products=CONV_EVAL_PRODUCTS,
                   grad_products=CONV_GRAD_PRODUCTS,
                   step_bwd_products=CONV_STEP_BWD_PRODUCTS,
                   outer_products=3)
# the SDE family's (kernels 10 and 12): an evaluation's two products in
# sequence (the drift's); a transposed step's reverse chain (two products a
# stage and a weight gradient's) and with its recompute (four stages of the
# drift's two)
SDE_GRAD_PRODUCTS = 9
SDE_STEP_BWD_PRODUCTS = 17
SDE_DEPTHS = dict(eval_products=EVAL_PRODUCTS,
                  grad_products=SDE_GRAD_PRODUCTS,
                  step_bwd_products=SDE_STEP_BWD_PRODUCTS,
                  outer_products=2)


# the score family's (kernels 11 and 6): an evaluation's three layers in
# sequence (2 -> 64 -> 64 -> 2)
SCORE_PRODUCTS = 3
# the latent model's (kernels 5 and 9): an evaluation of the generative
# chain's eight layers; the layers outside the DE layer on the path of the
# predictions (an encoder gate chain's two, rec_to_gen's two, gen_to_data's
# one); a transposed step's reverse chain (eight transposed products a
# stage, the weight gradients' one, and the outer layers' transposes and
# weight gradients) and with its recompute (seven evaluations of eight)
LATENT_DEPTHS = dict(eval_products=8, grad_products=6 * 8 + 1 + 2 * 5,
                     step_bwd_products=6 * 8 + 1 + 2 * 5 + 7 * 8,
                     outer_products=5)


def logits_tol(tiers_a, tiers_b, eval_products=EVAL_PRODUCTS,
               outer_products=OUTER_PRODUCTS, **_):
    """(tolerance, relative?) of two routes' logits at (forward, gradient)
    tiers ``tiers_a`` and ``tiers_b`` (``node_tiers``), both on the card or
    at its tiers, where the layers outside the DE layers compute at TF32:
    their TF32 rounding (``outer_products`` in sequence: the MNIST ODE's
    one, CIFAR's three, the MNIST SDE's two) and, with a TF32 forward on
    either side, one evaluation's (``eval_products``: the TD-MLP's two,
    the conv family's three), relative to the logits' scale,
    ``tf32_tol``."""
    depth = outer_products
    if "tf32" in (tiers_a[0], tiers_b[0]):
        depth += eval_products
    return tf32_tol(depth), True


def cross_entropy_tol(tiers_a, tiers_b, logits, **depths):
    """The cross-entropy's tolerance between two routes: CE_TOL; with a
    TF32 forward on either side at least twice the logits' (a softmax
    cross-entropy moves by at most twice its logits' largest change) at
    the scale of ``logits``."""
    tol, rel = logits_tol(tiers_a, tiers_b, **depths)
    if not rel:
        return CE_TOL
    return max(CE_TOL, 2 * tol * float(logits.abs().max()))


def grads_tol(tiers_a, tiers_b, fp32_tol=1e-3, tf32_recompute=False,
              grad_products=GRAD_PRODUCTS,
              step_bwd_products=STEP_BWD_PRODUCTS, **_):
    """The relative tolerance of two routes' gradients at (forward,
    gradient) tiers ``tiers_a`` and ``tiers_b``: ``fp32_tol`` when every
    product is FP32; else, same tiers or not, one transposed step's TF32
    rounding: its gradient products (the TD-MLP's 13, the conv family's 19)
    where either side's are TF32, and the stage recompute's (14, 18) where
    it is TF32 (a TF32 forward's, or ``tf32_recompute``: grad_precision
    'default'), ``fp32_tol`` at least."""
    depth = grad_products if "tf32" in (tiers_a[1], tiers_b[1]) else 0
    if tf32_recompute or "tf32" in (tiers_a[0], tiers_b[0]):
        depth += step_bwd_products - grad_products
    return max(fp32_tol, tf32_tol(depth)) if depth else fp32_tol


SWEEP_OUTPUTS = ("a_u", "a_k", "d_w1", "d_b1", "d_w2", "d_b2")


def on_cpu(args):
    """A sweep's operands (weights first) copied to the CPU."""
    return tuple(type(a)(*[t.cpu() for t in a]) if isinstance(a, tuple)
                 else a.cpu() for a in args)


def against_plains(ours, plain_card, plain_cpu):
    """A TF32 sweep's outputs (SWEEP_OUTPUTS) against its plain version on
    the card (cuBLAS's sums) and on the CPU (the CPU's). TF32 rounds every
    operand again after each sum, so two FP32 sum orders of one TF32
    computation flip roundings and part by TF32's rounding, not FP32's
    (the two plain versions print their distance: a_k ~1e-3 to ~6e-3
    apart, where at FP32 they are ~1e-6 to ~1e-3). The kernel is a third
    sum order: each output is held to twice the two plains' distance, and
    never below one swept step's truncated sums, tf32_sum_tol(27).
    Returns (the worst output's share of its gate, {output: "kernel vs
    CPU plain / card plain vs CPU plain"})."""
    worst, by = 0.0, {}
    for nm, a, c, p in zip(SWEEP_OUTPUTS, ours, plain_card, plain_cpu):
        e, yard = rel_err(a.cpu(), p), rel_err(c.cpu(), p)
        worst = max(worst, e / max(2 * yard,
                                   tf32_sum_tol(STEP_BWD_PRODUCTS)))
        by[nm] = f"{e:.2e}/{yard:.2e}"
    return worst, by


def utilde_ok(ut, ut_ref, ks, ks_ref, dt):
    """ũ = dt·Σ b̃_i k_i cancels, so its error is held to what its inputs'
    carry, dt·max|Δk| (Σ|b̃_i| < 1), not to its own scale: the TF32 noise
    in ũ that makes the tier unusable below rtol 1e-4."""
    dk = max(max_abs(a, b) for a, b in zip(ks, ks_ref))
    scale = max(float(k.abs().max()) for k in ks_ref)
    return max_abs(ut, ut_ref) <= float(dt) * (dk + 1e-6 * scale)


def tier_counts():
    """``launch_counts`` with the TD-MLP wrappers' launches by tier beside
    them, as ``name[tier]``."""
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, tier_launch_counts,
    )

    out = launch_counts()
    for name, by_tier in tier_launch_counts().items():
        out.update({f"{name}[{t}]": n for t, n in by_tier.items()})
    return out


def node_tiers(model, device):
    """(forward, gradient) product tiers of a classifier's NeuralODE (or
    NeuralDSDE) on its kernel route on ``device``: the forward at
    ``mm_precision``, the kernels' gradient products at the default tier
    (on the plain route they are the forward's)."""
    from localregneuralde_tpu_torch.nn import product_tier

    node = getattr(model, "neural_ode", None) or model.neural_dsde
    fwd = node.forward_tier(device)
    return fwd, fwd if node.use_pallas == "off" else product_tier(None, device)


def tiers_of(device):
    """``nn.tiers_of``: a CPU run inside it computes at ``device``'s tiers
    (the CPU references of the card's TF32 routes)."""
    from localregneuralde_tpu_torch.nn import tiers_of as scope

    return scope(device)


def _sde_input(model, x):
    """Kernel 10's check input: ``model``'s downsampled images ``x`` at
    FP32. The downsample takes the backend default (TF32 on the card), so
    it runs at the CPU's tiers here (``tiers_of("cpu")``): the digests keep
    the input they were taken on."""
    import torch

    with torch.no_grad(), tiers_of("cpu"):
        return model.downsample(model.flatten(x, {})[0], {})[0].contiguous()


def tdmlp_flops(b=B, f=F, h=H):
    """Product FLOPs of one TD-MLP evaluation of b rows."""
    return 2 * b * ((f + 1) * h + (h + 1) * f)


def tdmlp_weight_bytes(f=F, h=H):
    return 4 * ((f + 1) * h + h + (h + 1) * f + f)


def check(ok, what):
    if not ok:
        raise AssertionError(what)


def median_ms(fns, n=30, warmup=3):
    """Median CUDA-event time of each callable, launched in turns."""
    import torch

    for fn in fns:
        for _ in range(warmup):
            fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(n):
        for fn, ts in zip(fns, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [statistics.median(ts) for ts in times]


def back_to_back_ms(fns, n=200, warmup=10):
    """Device time per call of each callable: n calls back to back between
    two CUDA events, so the device is never idle as long as the host
    enqueues faster than the device runs. Callables run in turns."""
    import torch

    out = []
    for fn in fns:
        for _ in range(warmup):
            fn()
    for fn in fns + fns[::-1]:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    k = len(fns)
    return [min(out[i], out[2 * k - 1 - i]) for i in range(k)]


def raw_launch(name, *tensors_and_ints):
    """A launch of a C entry with its arguments marshalled once, for timing
    the kernel without the wrapper's per-call Python work."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    args = [_build.ptr(a) if isinstance(a, torch.Tensor) else a
            for a in tensors_and_ints]
    args.append(_build.stream_ptr(torch.device("cuda", 0)))
    fn = getattr(lib, name)

    def launch():
        return fn(*args)

    # the launch holds raw pointers: keep the tensors (often temporaries of
    # the caller) from returning to the allocator
    launch.tensors = tensors_and_ints
    return launch


def max_abs(a, b):
    return float((a - b).abs().max())


def kernel_split(label, fn, n=5, top=12):
    """Device time per call of ``fn`` by CUDA kernel, from torch.profiler
    over n calls: the attribution of a launch sequence (kernels 13, 14) to
    its kernels. Prints the largest ``top`` and returns {name: ms}."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.device_time_total / 1e3 / n, e.count / n)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"[split {label}] device {total:.4f} ms per call over "
          f"{sum(r[2] for r in rows):.0f} kernel launches")
    for key, ms, cnt in rows[:top]:
        print(f"[split {label}]   {1e3 * ms:9.2f} µs  x{cnt:5.1f}  {key[:100]}")
    return {key: ms for key, ms, _ in rows}


def sequence_split(label, fn, role, call_ms, n=5):
    """One call of a launch sequence (kernels 13, 12) by role: ``fn`` runs
    n times under torch.profiler, whose trace gives each kernel's device
    time; ``role(name, seen)`` names a kernel from its name and the roles
    before it in the call. Prints and returns {role: µs per call}, with
    "gaps" the call's device time back to back (``call_ms``) less its
    kernels' and "launches" their number."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    # a fill between calls marks where each begins (the trace may drop the
    # first events of a window): only calls between two marks are counted
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(n + 1):
            marker.fill_(float(i))
            if i < n:
                fn()
        torch.cuda.synchronize()
    os.makedirs("build", exist_ok=True)
    path = os.path.join("build", f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.unlink(path)
    ks = sorted((e for e in events if e.get("cat") in ("kernel", "gpu_memset")
                 and "dur" in e), key=lambda e: float(e["ts"]))
    marks = [i for i, e in enumerate(ks) if "FillFunctor" in e["name"]]
    calls = [ks[a + 1:b] for a, b in zip(marks, marks[1:])]
    check(calls and len({len(c) for c in calls}) == 1,
          f"{label}: calls of {[len(c) for c in calls]} device events")
    split = {}
    for call in calls:
        seen = []
        for e in call:
            name = "memset" if e["cat"] == "gpu_memset" else role(e["name"], seen)
            seen.append(name)
            split[name] = split.get(name, 0.0) + float(e["dur"]) / len(calls)
    busy = sum(split.values())
    split = {k: round(v, 2) for k, v in split.items()}
    split["gaps"] = round(1e3 * call_ms - busy, 2)
    split["launches"] = len(calls[0])
    print(f"[{label}] µs per call: {split}; kernels {busy:.1f} of "
          f"{1e3 * call_ms:.1f} back to back")
    return split


def conv_role(name, seen):
    """The role of a kernel in kernel 13's or 14's launch sequence: the
    N = 64 GEMMs of an evaluation are conv1 then conv2, the N = 8 one conv3;
    the rest by name."""
    for key, r in (("time_map", "time maps"), ("stage", "stage"),
                   ("bn_stats", "BN statistics"), ("bn_act", "bn_act"),
                   ("utilde", "utilde"), ("bn_ema", "EMA"),
                   ("reduce_partials", "partial sums"),
                   ("transpose_w", "transpose_w"), ("wgrad_time", "wgrad time"),
                   ("wgrad", "wgrad"), ("bn_bwd", "BN backward"),
                   ("seed", "seed")):
        if key in name:
            return r
    if "conv" in name and ("<128, 8," in name or "halo" in name):
        return "conv3"
    if "conv" in name:
        convs = [x for x in seen if x in ("conv1", "conv2", "conv3")]
        return "conv1" if not convs or convs[-1] != "conv1" else "conv2"
    return name[:60]


# SHA-256 of each persistent kernel's outputs at the main-path shapes (the
# inputs are made from fixed seeds), taken on the kernels before their
# redesign for the H100 (NVIDIA H100 80GB HBM3, 700 W): a kernel change
# that keeps a digest keeps every output bit and every accept and reject
# count. "K8 replay" holds kernel 8's window replay (the replayed states
# and their count), which its cluster redesign keeps; "K8 grads" holds its
# gradients, whose sums the redesign reordered on purpose, taken on the
# cluster sweep; "K3" holds kernel 3's VJP, taken on its cluster redesign
# (a new order too). The K4 digests hold through kernel 4's cluster
# redesign. Kernel 9's outputs are held in three parts, so that a change
# of the gradient sums' order (allowed) shows apart from the replay and
# the per-row carries (which must keep every bit): "K9 replay", "K9
# state" (a_u, a_k) and "K9 grads". Kernel 12's, "K12 state" (a_u) and
# "K12 grads", hold through its twelve-warp redesign. Kernel 13's are taken
# on its Hopper redesign, whose BatchNorm statistics come from the convs'
# tile moments (a new order): "K13 train" and "K13 eval batch" (and "K14",
# whose recompute is kernel 13's forward) new, "K13 eval" (the running
# stats, no statistics) bitwise the first port's. "K1" (kernel 1 at B = 512
# and 410, s = 0 and 0.3) and "K2" (kernel 2's nine outputs at B = 512 and
# 410, t = 0.2, dt = 0.05, from kernel 1's k1) are taken on the first ports
# and hold through their cluster redesign. "K15 tap" and "K15 im2col" (both
# layouts' outputs at [conv orient]'s inputs) are taken on kernel 15's
# tensor-core redesign, whose 3xTF32 sums run in wgmma's order (a new order
# on purpose; the first port's were 870e470e... and 78a25b53...); the two
# are equal, the layouts doing the same sums.
DIGESTS = {
    "K1":
        "a54e79251265007d0f4ae5849a5a03985be719f3e334dcbacdf718e01035aa65",
    "K2":
        "60dd02473c7d3b05e83524d341f72a27056f05a6fbfb8724d79c8b46ae07b67b",
    "K4 mlp.yaml":
        "e44871cbccc65b5feb83750178380cfcdbac0317ef585369813d08c465a56029",
    "K4 bench":
        "bf789bca4fd75e5bb07066515e9102d61196f8c56f8ac982546b2e01727976bc",
    "K8 replay":
        "18d61a9defd0c37a8e93b51554cd89a7c5f78ffc5c973121706f836cd6b4567f",
    "K8 grads":
        "3cd7a5e6ea73b811fb8ff013aefe61b326aa8130d975936a11ba0eb9037c5ced",
    "K10":
        "72b959a34b87650bad4b784b84c7b5dbc53c37bf70d70403fc4b2963c6fe830c",
    "K5 rtol 1e-4":
        "b249d5250be740ccd0e62939cbf00b89a5e82fe59c661153dbd9e3e0670eda1d",
    "K5 physionet.yaml":
        "2189bcf02c57a002c6ee4ddde4b2d4aec3794f97c1c66d9f7f70e8ac56d71572",
    "K5 eval":
        "7e135b5a96a83cca479a4a88b33c6e359ca0d245fa7aa83b813637bf25416142",
    "K9 replay":
        "e2410e602444f526465dca083879e563db76ad79b557cd3b2a19d43326ea262a",
    "K9 state":
        "13638150be4d62172a79573e86c5b7238afeb73943f57afb62b9454e92d62214",
    "K9 grads":
        "04d56694f4173633f6994b785832b1ffb0e1ef4f2985b3e155ac313c50454c94",
    "K11":
        "345c6f0924ead73e5b152bc7c59d5dac3a1b527399e1b971c14fd44dbc51b404",
    "K6":
        "ee519b3048e636d24150dae433d8436a65634d560e3cf8e544b4aff49d16c6f6",
    "K3":
        "98440d6fa0bef5f97702c62325f4a882205ac07a0bba2c405e03241d81f69f50",
    "K12 state":
        "a912e956ef195bffddc48954ddee91beeef13fab15a4091bd8b3a6b29e51dd0d",
    "K12 grads":
        "4b59f81c42858e2183612bff7554859bae1f7dc2ab8b4fc369ae5a35ced49dd0",
    "K13 train":
        "e671ffde7f09884869a4be91571dec3172d1fb81646e0d063c79ac19a4e0c284",
    "K13 eval":
        "96bcb09f75939c214289cc939a748aac9292873a4539ed819ee48cda31c7a424",
    "K13 eval batch":
        "ca9f88fe5ce6a853a9ba2a6b0659dfe20b46d5692ae23c964ac63511093b45f5",
    "K14":
        "250f93031de4b10a367798498581d9e3701cd576dd5fcef85d4a2b4ea66b64ab",
    "K15 tap":
        "2eb4880f6f150bedab40cad3b4ef33ba1fe90239f1e0452bd0f712b075070687",
    "K15 im2col":
        "2eb4880f6f150bedab40cad3b4ef33ba1fe90239f1e0452bd0f712b075070687",
    # the TF32 tier (the reference's 'default'), taken on the first build of
    # the TF32 instantiations ([tf32 ...])
    "K1 tf32":
        "1ee235493992af8265f65c8eea0e13bca9dfe4c41844a3c6b9d0bead4c6020da",
    "K2 tf32":
        "7303ce96eac3826ac23b2041f7d8992e3cf27faaeedc1f942534eae7d60db829",
    "K4 bench tf32":
        "1decd2a9adfbcb7f6767e8e08a578d688751e818cfbd9cc99ac901434def4448",
    "K3 tf32":
        "279dada7e47b4c138ec63a35b220124cedb4c274d4197ee10d3a49ff3a7a32c3",
    "K8 grads tf32":
        "961477859a879355648da38de3590b4eed13eab9c6a2c879b87c9924eb913e33",
    "K8 replay tf32":
        "d313b126d352c2491e3dd7666ccd9e9a3db03da258abcc9f41221cfe7f4957ab",
    # the conv family's TF32 tier, taken on the first build of the TF32
    # instantiations of conv_core.cuh ([tf32 conv ...]): kernel 13 in its
    # three modes, kernel 14 TF32 throughout (cnn.yaml's route) and with an
    # FP32 recompute ('highest''s)
    "K13 train tf32":
        "05f1a2c285d64596b7bd3b5577aeee4a741b118e2af22a307f059474d42186a0",
    "K13 eval tf32":
        "629818721592920a6f054752e21f33bb82aa44ef9c01eb76667f738d27bd0ac9",
    "K13 eval batch tf32":
        "f9597aef66319f00a0c1582f8f90f90d2ce3629ef060a7ef87b989a4b8ae3794",
    "K14 tf32":
        "c7e9aa43d103ef5c783858b908cbe5c33312bb6939602b4b0f939187095977a3",
    "K14 grads tf32":
        "5a3da083323d78801f169c2a9fdf08a79ca41acf9a60621260f4f470db47d374",
    # the SDE family's TF32 tier, taken on the first build of the TF32
    # instantiations of sde.cuh ([tf32 sde ...]): kernel 10 at TF32, kernel
    # 12 TF32 throughout (mnist_sde's 'auto') and with an FP32 recompute
    # ('highest''s), on kernel 10's TF32 knots
    "K10 tf32":
        "f5b5aebe2aefa73a25a1752b4f705cf8b48a7786bcffd95035cf6205476e2807",
    "K12 state tf32":
        "8dc6601e5d01efdb0ff707bddf15fc04ea8886a71cb2200a8fdc01d923bbca71",
    "K12 grads tf32":
        "8e98d64346dbe367682856b67f5a2decf19151c3715e60b9f691950eae58327e",
    "K12 state tf32g":
        "ba498a8bd93127a912fa62c5d52b4f560cb36d4da9913d5a6ffd14d076feedfd",
    "K12 grads tf32g":
        "d2a94f4f692db9b02f0e363b903cadea9e91d037460bd933854b8430d1e44ad9",
    # the score and chain families' TF32 tier, taken on the first build of
    # their TF32 instantiations ([tf32 score ...], [tf32 chain ...]): kernel
    # 11 and kernel 6 at TF32; kernel 5 at TF32 at rtol 1e-4 (physionet.yaml's
    # 1.4e-8 refuses the tier) at the training and the eval shapes and its
    # recorded knots; kernel 9 at tiers 2 (FP32 replay and recompute, TF32
    # gradients: physionet.yaml's route) on kernel 5's FP32 knots, at TF32
    # throughout on kernel 5's TF32 knots, and its forced TF32 replay (equal
    # to the knots it repeats)
    "K11 tf32":
        "c457b6d6c837f9104444d7738737e40fba35cd880b10ddea2b3bad9e1993f11c",
    "K6 tf32":
        "10807cdc1beab4383b69f35c2de76f414e2d168ddc912bd68e3839a76b637e8d",
    "K5 rtol 1e-4 tf32":
        "a77b6bb1a3feb63d1ff9ac4ea98e9cebb5610a3c25abb35b2ab5c7403802aa76",
    "K5 eval tf32":
        "a6680986cd1e94bee85d1dd206f5964c40984fdbc5acc4f8f8300fe3b0a7389f",
    "K5 record tf32":
        "0efd9c18f1a18fff0c0c8bb4a6a7c8f0eeff20ee3d335af68b2f684679a85a86",
    "K9 state tf32g":
        "5ea605ef0d8c2c374b63db8321cf05b8c46ffe82a5694ca4bce27796573dd7ba",
    "K9 grads tf32g":
        "b7636e77439d16ae112c7e3a7699f1085ef814cf141fb73058f3611064cd3cb9",
    "K9 state tf32":
        "de74362d89c505de55bb95e702969b5922a696374a959acc11bc6463161e143b",
    "K9 grads tf32":
        "f01428ac703eba568e36c22d8b93e9137363be160809ff50f80e702fca984016",
    "K9 replay tf32":
        "0efd9c18f1a18fff0c0c8bb4a6a7c8f0eeff20ee3d335af68b2f684679a85a86",
}
SEEN_DIGESTS = {}
# Kernel 3's largest error relative to the float64 plain VJP, on the kernel
# before its cluster redesign ([step_bwd fp64], NVIDIA H100 80GB HBM3, 700 W):
# the redesign may at most double it.
K3_FP64_BEFORE = 3.719e-7
# Kernel 9's weight gradients' largest error relative to the float64 plain
# sweep ([chain sweep fp64], dense at physionet.yaml on kernel 5's knots), on
# the kernel before its redesign: the redesign may at most double it.
K9_FP64_BEFORE = 8.512e-7
# Kernel 13's BatchNorm statistics (the last evaluation's mean and variance
# of z1 and z2 in training mode) against float64 two-pass statistics of the
# same z, largest |mean error| / std and |var error| / var, on the kernel
# before its Hopper redesign ([conv stats fp64]): the redesign may at most
# double them.
K13_STATS_FP64_BEFORE = (5.064e-7, 4.848e-7)
# Kernel 12's weight gradients' largest error relative to the float64 plain
# sweep on kernel 10's knots ([sde sweep fp64]), on the kernel before its
# Hopper redesign: the redesign may at most double it.
K12_FP64_BEFORE = 4.438e-7
# Device ms per call back to back of kernels 13 (training, eval with the
# running stats), 14, 12, 10, 6, 1, 2 and 15 before their Hopper redesign,
# measured by this script's [conv attribution], [sde sweep], [sde solve],
# [pf solve], [kernel ...] and [conv orient] (the last five as raw
# launches) on the parent tree (NVIDIA H100 80GB HBM3, 700 W), printed
# beside this run's.
PARENT_MS = {"K13 train": 1.2836, "K13 eval": 1.0128, "K14": 3.7444,
             "K12": 1.908, "K10": 0.9097, "K6": 0.9225, "K1": 0.0349,
             "K2": 0.2169, "K15 tap": 0.09052, "K15 im2col": 0.26503}
# Rows of kernel 6's error blocks (the slots of its error norm)
PF_ERROR_ROWS = 8
DIGEST_KEYS = ("y_final", "ys", "naccept", "nreject", "natt")


def digest(name, *values):
    """Hash the tensors (bytes, dtype, shape) and integers ``values`` (a
    solve's dict contributes its ``DIGEST_KEYS``), print the digest, and
    fail if it differs from ``DIGESTS[name]``."""
    import torch

    h = hashlib.sha256()
    for v in values:
        if isinstance(v, dict):
            vs = [v[k] for k in DIGEST_KEYS if k in v]
        else:
            vs = [v]
        for x in vs:
            if isinstance(x, torch.Tensor):
                x = x.detach().contiguous().cpu()
                h.update(f"{x.dtype}{tuple(x.shape)}".encode())
                h.update(x.numpy().tobytes())
            else:
                h.update(repr(int(x)).encode())
    got = h.hexdigest()
    SEEN_DIGESTS[name] = got
    want = DIGESTS.get(name)
    tag = "" if want is None else (" = the stored digest" if want == got
                                   else f" != the stored {want}")
    print(f"[digest {name}] {got}{tag}")
    check(want is None or want == got, f"digest {name} changed")


def phase_build():
    from localregneuralde_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"[build] {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if ("Compiling entry" in line or "registers" in line
                or "spill" in line or "compiled in" in line):
            print("[build]", line.strip())
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi)
    global CARD
    CARD = smi


def phase_kernels(device):
    """Each kernel against its plain version at the slice's shapes."""
    import torch

    from localregneuralde_tpu_torch.harness import synthetic_classification
    from localregneuralde_tpu_torch.nn import glorot_uniform
    from localregneuralde_tpu_torch.ops.cuda import (
        TDMLPWeights, fused_tdmlp, fused_tsit5_step, persistent_tsit5_solve,
        persistent_tsit5_solve_plain, tdmlp_plain, tsit5_step_plain,
    )

    g = torch.Generator().manual_seed(0)
    w = TDMLPWeights(
        glorot_uniform((F + 1, H), g), 0.1 * torch.randn(H, generator=g),
        glorot_uniform((H + 1, F), g), 0.1 * torch.randn(F, generator=g),
    )
    w = TDMLPWeights(*(t.to(device) for t in w))
    x = torch.tensor(
        synthetic_classification(seed=0)[2][:B].reshape(B, F), device=device
    )
    res = {}

    # kernel 1 — FP32 sums in another order than cuBLAS: expect ≤ 1e-6
    err = max_abs(fused_tdmlp(w, x, 0.3), tdmlp_plain(w, x, 0.3))
    check(err <= 1e-4, f"tdmlp vs plain: max-abs {err}")
    raw = raw_launch("lrnde_tdmlp", x, torch.tensor([0.3], device=device),
                     *w, torch.empty_like(x), B, F, H, 0)
    check(raw() == 0, "tdmlp: raw launch failed")
    ms, plain = back_to_back_ms([raw, lambda: tdmlp_plain(w, x, 0.3)])
    call, = median_ms([lambda: fused_tdmlp(w, x, 0.3)])
    res["tdmlp"] = dict(max_abs_err=err, ms=ms, plain_ms=plain, call_ms=call,
                        **bound(tdmlp_flops(), 8 * B * F + tdmlp_weight_bytes()))
    digest("K1", *[fused_tdmlp(w, x[:b], s) for b in (B, 410)
                   for s in (0.0, 0.3)])

    # kernel 2 — all nine outputs
    t = torch.tensor(0.2, device=device)
    dt = torch.tensor(0.05, device=device)
    k1 = tdmlp_plain(w, x, t)
    err = max(max_abs(a, b) for a, b in zip(
        fused_tsit5_step(w, x, t, dt, k1), tsit5_step_plain(w, x, t, dt, k1)
    ))
    check(err <= 1e-4, f"tsit5_step vs plain: max-abs {err}")
    # the digest's k1 is kernel 1's (held by "K1"), as on the main path
    digest("K2", *[o for b in (B, 410) for o in fused_tsit5_step(
        w, x[:b], t, dt, fused_tdmlp(w, x[:b], t))])
    raw = raw_launch("lrnde_tsit5_step", *step_raw_args(w, x, k1, t, dt))
    check(raw() == 0, "tsit5_step: raw launch failed")
    ms, plain = back_to_back_ms([raw, lambda: tsit5_step_plain(w, x, t, dt, k1)])
    call, = median_ms([lambda: fused_tsit5_step(w, x, t, dt, k1)])
    res["tsit5_step"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             call_ms=call,
                             **bound(6 * tdmlp_flops(),
                                     44 * B * F + tdmlp_weight_bytes()))

    # kernel 4 — the whole solve against the eager loop with the plain step
    saveat = torch.tensor([0.5, 1.0], device=device)
    for name, overrides in TOLERANCES:
        tol = 1e-4 if overrides else 1.4e-8
        kw = dict(rtol=tol, atol=tol, saveat_arr=saveat,
                  max_steps=64 if overrides else 10000)
        out = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
        digest(f"K4 {name}", out)
        ref = persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw)
        err = max_abs(out["ys"], ref["ys"])
        na, nb = int(out["naccept"]), int(ref["naccept"])
        fa, fb = int(out["nfe"]), int(ref["nfe"])
        print(f"[solve {name}] kernel naccept {na} nfe {fa} | loop naccept "
              f"{nb} nfe {fb} | ys max-abs {err:.3e}")
        check(bool(out["success"]) and bool(ref["success"]),
              f"persistent solve {name}: not successful")
        if overrides:
            # rtol 1e-4: the two agree step for step up to an ulp-level
            # accept flip in the cancelling error sum (measured on an H100:
            # 4 accepts and NFE 26 both, ys max-abs 1.4e-6)
            check(err <= 2e-4 and abs(na - nb) <= 1 and abs(fa - fb) <= 12,
                  f"persistent solve {name} disagrees with the loop")
        else:
            # rtol 1.4e-8 is below the f32 rounding noise of ũ: a float64
            # step at the same point has a ~50x smaller eest, so each
            # implementation's step count follows the accuracy of its sums.
            # Measured on an H100 80GB HBM3 (700 W): kernel 25 accepts, loop
            # 28, both without rejects, ys max-abs 1.1e-6; summation variants
            # of the kernel gave 25-33 accepts against the loop's 28.
            check(err <= 1e-5 and 0.75 <= na / nb <= 1.34,
                  f"persistent solve {name} disagrees with the loop")
        ms, plain = median_ms(
            [lambda: persistent_tsit5_solve(w, x, (0.0, 1.0), **kw),
             lambda: persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw)],
            n=10, warmup=1,
        )
        # the kernel's six evaluations per attempt; in u0 and k1_0, out ys
        # and y_final
        b4 = bound(6 * tdmlp_flops() * (fa - 2) // 6,
                   4 * (3 + saveat.shape[0]) * B * F + tdmlp_weight_bytes())
        print(f"[solve {name}] kernel {ms:.3f} ms, loop {plain:.3f} ms | "
              f"bound {b4['bound_ms']:.4f} ms ({fa - 2} evaluations, "
              f"{b4['bound_by']})")
        if overrides:
            res["persistent_tsit5_solve"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, call_ms=ms, **b4)
    for name, r in res.items():
        print(f"[kernel {name}] max-abs {r['max_abs_err']:.3e} | device "
              f"time per launch {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms"
              f" | one wrapper call {r['call_ms']:.4f} ms"
              + (f" (parent {PARENT_MS[k]:.4f} ms)" if (
                  k := {"tdmlp": "K1", "tsit5_step": "K2"}.get(name))
                 else ""))
    res["persistent_tsit5_solve"].pop("call_ms")
    return w, x, res


def step_raw_args(w, x, k1, t, dt, rows=0, timing=None):
    """The operands of a raw ``lrnde_tsit5_step`` launch (kernel 2) from
    (x, t) with step dt, fresh outputs and scratch: ``rows`` rows a
    cluster (0: the wrapper's grid), ``timing`` the clocked
    instantiation's counters (None: the untimed kernel)."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda.fused_solve import eval_layout

    b = x.shape[0]
    plan = eval_layout(b, F, H)[1]
    return (x, k1, torch.stack([t, dt]), *w,
            *[torch.empty_like(x) for _ in range(9)],
            torch.empty(plan.scratch_floats, device=x.device), b, F, H, rows,
            timing)


def phase_determinism(w, x):
    from localregneuralde_tpu_torch.ops.cuda import persistent_tsit5_solve

    import torch

    for name, overrides in TOLERANCES:
        tol = 1e-4 if overrides else 1.4e-8
        kw = dict(rtol=tol, atol=tol, max_steps=64 if overrides else 10000,
                  saveat_arr=torch.tensor([1.0], device=x.device))
        a = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
        b = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
        check(torch.equal(a["y_final"], b["y_final"])
              and int(a["nfe"]) == int(b["nfe"]),
              f"persistent solve {name} is not deterministic")
        print(f"[determinism {name}] bitwise-equal y_final, nfe {int(a['nfe'])}")


def _slice_model(overrides, device, params=None):
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, create_train_state,
        define_configuration, make_eval_step,
    )

    cfg = define_configuration(overrides, CONFIG)
    model = construct_model(cfg, device=device)
    if params is not None:
        model.load_state_dict(params)
    loss_fn, w_reg = construct_loss(cfg)
    return model, make_eval_step(model, loss_fn), create_train_state(model), w_reg(1)


def phase_slice(device, profile=False):
    """The serving path at both tolerances, with launch counts; with
    ``profile`` the mlp.yaml batch by part (``_profile_serve``)."""
    import torch

    from localregneuralde_tpu_torch.harness import (
        accuracy, one_hot, synthetic_classification,
    )
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    _, _, x_test, y_test = synthetic_classification((28, 28), 1, 10, seed=0)
    batches = [
        (torch.tensor(x_test[i * B:(i + 1) * B], device=device),
         torch.tensor(one_hot(y_test[i * B:(i + 1) * B], 10), device=device))
        for i in range(N_BATCHES)
    ]
    runs = []
    for name, overrides in TOLERANCES:
        model, step, ts, w_reg = _slice_model(overrides, device)
        loop_model, loop_step, loop_ts, _ = _slice_model(
            overrides + ["--model.solver.use_persistent=false"], device,
            model.state_dict(),
        )
        runs.append((name, overrides, model, step, ts, w_reg, batches))
        runs.append((name + " loop", overrides, loop_model, loop_step,
                     loop_ts, w_reg, batches[:1]))
    for step, ts, w_reg in [(r[3], r[4], r[5]) for r in runs]:
        step(ts, batches[0], w_reg)  # first-call set-up (cuBLAS, allocator)
    torch.cuda.synchronize()

    # --- the main path: every launch from here to launch_counts() counts
    reset_launch_counts()
    results = []
    for name, overrides, model, step, ts, w_reg, bs in runs:
        for i, (x, y) in enumerate(bs):
            t0 = time.perf_counter()
            loss, stats = step(ts, (x, y), w_reg)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            results.append((name, i, loss, stats, ms))
    counts = tier_counts()

    n_persistent = sum(len(r[6]) for r in runs if not r[0].endswith("loop"))
    n_loop = sum(len(r[6]) for r in runs if r[0].endswith("loop"))
    loop_attempts = 0
    for name, i, loss, stats, ms in results:
        nfe = int(stats["nfe"])
        ok = bool(stats["solver_success"])
        top1 = float(accuracy(stats["y_pred"], batches[i][1]))
        print(f"[slice {name}] batch {i}: loss {float(loss):.6f} top-1 "
              f"{top1:.2f}% nfe {nfe} success {ok} {ms:.3f} ms "
              f"{B / (ms / 1e3):.1f} images/s")
        check(ok and bool(torch.isfinite(loss))
              and tuple(stats["y_pred"].shape) == (B, 10)
              and bool(torch.isfinite(stats["y_pred"]).all()),
              f"slice {name} batch {i}: bad output")
        if name.endswith("loop"):
            loop_attempts += (nfe - 2) // 6
    print(f"[slice] launch counts {counts}")
    check(counts["persistent_tsit5_solve"] == n_persistent,
          "the persistent kernel did not run once per batch")
    check(counts["tdmlp"] == 2 * (n_persistent + n_loop),
          "the tdmlp kernel did not run twice per batch")
    check(counts["tsit5_step"] == loop_attempts,
          "the step kernel did not run once per loop attempt")

    # --- the same batches on the plain path, on the card and on the CPU
    for (name, overrides, model, step, ts, w_reg, bs) in runs:
        if name.endswith("loop"):
            continue
        plain = _slice_model(overrides + ["--model.use_pallas=off"], device,
                             model.state_dict())
        for i, (x, y) in enumerate(bs):
            _, ref = plain[1](plain[2], (x, y), w_reg)
            ours = next(r[3] for r in results if r[0] == name and r[1] == i)
            err = max_abs(ours["y_pred"], ref["y_pred"])
            print(f"[slice {name}] batch {i}: logits vs plain path max-abs "
                  f"{err:.3e}, nfe {int(ours['nfe'])} vs {int(ref['nfe'])}")
            # the plain route at the kernels' tiers (node_tiers)
            tol, rel = logits_tol(node_tiers(model, device),
                                  node_tiers(plain[0], device))
            if rel:
                err = rel_err(ours["y_pred"], ref["y_pred"])
                print(f"[slice {name}] batch {i}: both TF32, relative "
                      f"{err:.3e}, tolerance {tol:.3e} (one evaluation's "
                      f"TF32 rounding)")
            check(err <= tol, f"slice {name}: logits disagree with plain")
        # a small batch: the card's kernel path against the CPU, which
        # computes at the card's tiers (tiers_of: the TF32 tier's operands
        # rounded bitwise as the card rounds them)
        cpu = _slice_model(overrides, "cpu",
                           {k: v.cpu() for k, v in model.state_dict().items()})
        xs, ys = bs[0][0][:8], bs[0][1][:8]
        _, on_card = step(ts, (xs, ys), w_reg)
        with tiers_of("cuda"):
            _, on_cpu = cpu[1](cpu[2], (xs.cpu(), ys.cpu()), w_reg)
        err = max_abs(on_card["y_pred"].cpu(), on_cpu["y_pred"])
        tiers = node_tiers(model, device)
        tol, rel = logits_tol(tiers, node_tiers(cpu[0], "cuda"))
        if rel:
            err = rel_err(on_card["y_pred"].cpu(), on_cpu["y_pred"])
        print(f"[slice {name}] 8 images, card kernels vs CPU plain at the "
              f"card's tiers ({tiers[0]}): nfe {int(on_card['nfe'])} vs "
              f"{int(on_cpu['nfe'])}, logits {'relative ' if rel else ''}"
              f"max-abs {err:.3e}, tolerance {tol:.3e}")
        check(err <= tol, f"slice {name}: card disagrees with the CPU")
    if profile:
        _profile_serve(runs[0], batches)
    return counts


def _profile_serve(run, batches, rounds=10):
    """The mlp.yaml serving batch by part. Host clocks, each part ending
    in a synchronise, ``rounds`` rounds in turns (min / median / max): the
    whole eval step; the solve's wrapper call alone; its start (k1_0 and
    the Hairer probe: kernel 1 twice and the small torch ops around it).
    Then three batches under torch.profiler: the device time of kernel 4,
    of kernel 1 and of every other device operation (count and time), and
    the rest of the batch's wall time, which the host spends."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from localregneuralde_tpu_torch.ops.cuda import (
        fused_solve, fused_tdmlp, persistent_tsit5_solve,
    )

    name, _, model, step, ts, w_reg, _ = run
    node = model.neural_ode
    w = node.tdmlp_weights()
    x, y = batches[0]
    u0 = x.reshape(B, F).contiguous()
    kw = dict(rtol=node.rtol, atol=node.atol, max_steps=node.max_steps,
              saveat_arr=torch.tensor([node.tspan[1]], device=x.device))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    parts = {
        "eval step": lambda: step(ts, (x, y), w_reg),
        "solve call": lambda: persistent_tsit5_solve(w, u0, node.tspan, **kw),
        "start": lambda: fused_solve._start(
            lambda u, t: fused_tdmlp(w, u, t), u0, node.tspan[0],
            node.tspan[1], node.rtol, node.atol),
    }
    times = {k: [] for k in parts}
    for _ in range(rounds):
        for k, fn in parts.items():
            times[k].append(timed(fn))
    spread = {k: "{:.3f} / {:.3f} / {:.3f}".format(
        min(v), statistics.median(v), max(v)) for k, v in times.items()}
    print(f"[profile serve {name}] host ms, {rounds} rounds in turns, min / "
          f"median / max: {spread}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            step(ts, batches[i], w_reg)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 3
    groups = {"kernel 4": [0.0, 0.0], "kernel 1": [0.0, 0.0],
              "other device ops": [0.0, 0.0]}
    rows = []
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.device_time_total <= 0):
            continue
        ms, cnt = e.device_time_total / 1e3 / 3, e.count / 3
        g = ("kernel 4" if "cluster_solve_kernel" in e.key
             else "kernel 1" if "tdmlp" in e.key else "other device ops")
        groups[g][0] += ms
        groups[g][1] += cnt
        rows.append((ms, cnt, e.key))
    busy = sum(v[0] for v in groups.values())
    print(f"[profile serve {name}] {wall:.3f} ms a batch under the profiler; "
          + "; ".join(f"{g} {v[0]:.4f} ms x{v[1]:.1f}"
                      for g, v in groups.items())
          + f"; host beyond the device {wall - busy:.3f} ms")
    for ms, cnt, key in sorted(rows, reverse=True)[:12]:
        print(f"[profile serve {name}]   {1e3 * ms:9.2f} µs  x{cnt:5.1f}  "
              f"{key[:90]}")


def phase_solve_cluster(w, x):
    """Kernel 4's cluster layout, and kernels 1 and 2 on it against kernel
    4's own arithmetic, at B = 512 and 410: one attempt of kernel 4
    (max_steps 1, from the wrapper's own start) against kernel 2's step
    from the same state, u_new and k2..k7 bitwise (kernel 4's buffers read
    from its scratch through ``fused_solve.segment_index``); and kernel 1
    at (u_new, dt) bitwise kernel 4's k7, the attempt's last evaluation."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        fused_solve, fused_tdmlp, fused_tsit5_step,
    )

    lib = _build_lib()
    plan = fused_solve.solve_plan(B, F, H)
    clusters = lib.lrnde_solve_clusters(B, F, H)
    check(clusters >= 1, f"solve cluster query failed: {clusters}")
    print(f"[solve cluster] {clusters} clusters of {plan.cluster} CTAs "
          f"resident for {len(plan.row_blocks)} row blocks of {plan.rows}; "
          f"weight slices in shared memory {plan.weights_shared}; "
          f"{plan.smem_bytes} B of shared memory a CTA")
    tol, span = 1e-4, 1.0
    idx = fused_solve.segment_index(F).to(x.device)
    for b in (B, 410):
        xb = x[:b].contiguous()
        k1_0, dt0, _ = fused_solve._start(lambda u, t: fused_tdmlp(w, u, t),
                                          xb, 0.0, span, tol, tol)
        scratch = torch.empty(fused_solve.solve_plan(b, F, H).scratch_floats,
                              device=x.device)
        one = fused_solve._launch_solve(
            w, xb, (0.0, span), rtol=tol, atol=tol, max_steps=1,
            saveat_arr=torch.tensor([span], device=x.device), scratch=scratch)
        check(int(one["naccept"]) == 1, "the first attempt was rejected")
        # u, u_new, k1..k7 of the attempt, row-major
        bufs = scratch.view(9, b, -1)[:, :, idx]
        check(torch.equal(bufs[0], xb) and torch.equal(bufs[2], k1_0)
              and torch.equal(bufs[1], one["y_final"]),
              f"kernel 4's scratch is not in the segment layout (B = {b})")
        step = fused_tsit5_step(w, xb, torch.zeros((), device=x.device), dt0,
                                k1_0)
        check(torch.equal(one["y_final"], step[0]),
              f"kernel 4's first step differs from kernel 2's (B = {b}): "
              f"max-abs {max_abs(one['y_final'], step[0])}")
        for j in range(6):
            check(torch.equal(bufs[3 + j], step[2 + j]),
                  f"k{j + 2} of kernel 4's attempt differs from kernel 2's "
                  f"(B = {b}): max-abs {max_abs(bufs[3 + j], step[2 + j])}")
        k7 = fused_tdmlp(w, one["y_final"], dt0)
        check(torch.equal(k7, bufs[8]),
              f"kernel 1 differs from kernel 4's evaluation (B = {b}): "
              f"max-abs {max_abs(k7, bufs[8])}")
    print("[solve cluster] B = 512, 410: kernel 4's first attempt bitwise "
          "kernel 2's step (u_new, k2..k7); kernel 1 at (u_new, dt) bitwise "
          "kernel 4's k7")


# kernel 2's step by phase (lrnde_step_phases), in order
STEP_PHASES = (*[f"input {i}" for i in range(2, 8)],
               *[f"product1 {i}" for i in range(2, 8)],
               *[f"hidden {i}" for i in range(2, 8)],
               *[f"product2 {i}" for i in range(2, 8)],
               "weights", "layout in", "layout out")
def phase_tdmlp_attribution(w, x, runs=3):
    """Kernels 1 and 2 on their clusters at the mlp.yaml width: their grids
    (``eval_plan``, checked against the library) at B = 512 and 410;
    kernel 2's step by phase from the clocked instantiation (CTA 0's
    %globaltimer, the mean of ``runs`` launches), bitwise its untimed self;
    then the grid probe (the rows that fill the resident clusters against
    40 a cluster) of both kernels, each bitwise the wrapper's result,
    device ms per launch back to back."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        fused_tdmlp, fused_tsit5_step,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_solve import eval_layout

    lib = _build_lib()
    check(lib.lrnde_step_phases() == len(STEP_PHASES),
          "the step kernel's phases are not STEP_PHASES")
    for b in (B, 410):
        plan = eval_layout(b, F, H)[1]
        print(f"[tdmlp attribution] B = {b}: {plan.clusters} clusters of "
              f"{plan.cluster} CTAs, {plan.rows} rows a cluster (at most "
              f"{plan.rows_max}), {len(plan.row_blocks)} row blocks; weight "
              f"slices in shared memory {plan.weights_shared}; "
              f"{plan.smem_bytes} B of shared memory a CTA")
    t = torch.tensor(0.2, device=x.device)
    dt = torch.tensor(0.05, device=x.device)
    k1 = fused_tdmlp(w, x, t)
    ref = fused_tsit5_step(w, x, t, dt, k1)
    timing = torch.zeros(len(STEP_PHASES) + 1, dtype=torch.int64,
                         device=x.device)
    totals = torch.zeros(len(STEP_PHASES) + 1, dtype=torch.float64)
    for i in range(runs + 1):
        args = step_raw_args(w, x, k1, t, dt, timing=timing)
        check(raw_launch("lrnde_tsit5_step", *args)() == 0,
              "tdmlp attribution: the timed launch failed")
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) for a, b in zip(args[7:16], ref)),
              "tdmlp attribution: the timed step's result differs")
        if i > 0:  # the first launch warms up
            totals += timing.cpu().double()
    per = (totals[:-1] / totals[-1] / 1e3).tolist()
    split = {name: round(us, 3) for name, us in zip(STEP_PHASES, per)}
    groups = {g: round(sum(v for k, v in split.items() if k.startswith(g)), 3)
              for g in ("input", "product1", "hidden", "product2", "weights",
                        "layout")}
    print(f"[tdmlp attribution] kernel 2's step at B = {B}, CTA 0, µs (mean "
          f"of {runs} launches): {split}; by kind {groups}; sum "
          f"{sum(per):.3f}; bitwise the untimed kernel")
    want = fused_tdmlp(w, x, 0.3)
    s_dev = torch.tensor([0.3], device=x.device)
    probes = []
    for rows in (0, 40):
        out = torch.empty_like(x)
        fn = raw_launch("lrnde_tdmlp", x, s_dev, *w, out, B, F, H, rows)
        check(fn() == 0 and torch.equal(out, want),
              f"kernel 1, rows {rows}: differs from the wrapper")
        probes.append((f"K1 {rows or 'filled'} rows", fn))
        args = step_raw_args(w, x, k1, t, dt, rows=rows)
        fn = raw_launch("lrnde_tsit5_step", *args)
        check(fn() == 0 and all(torch.equal(a, b)
                                for a, b in zip(args[7:16], ref)),
              f"kernel 2, rows {rows}: differs from the wrapper")
        probes.append((f"K2 {rows or 'filled'} rows", fn))
    ms = back_to_back_ms([fn for _, fn in probes], n=50)
    print("[tdmlp probe] device ms per launch back to back, each bitwise "
          "the wrapper's: " + "; ".join(
              f"{label} {m:.4f}" for (label, _), m in zip(probes, ms)))
    return split


# the attribution phases of kernel 4's attempt (lrnde_solve_phases), in order
SOLVE_PHASES = (*[f"input {i}" for i in range(2, 8)],
                *[f"product1 {i}" for i in range(2, 8)],
                *[f"hidden {i}" for i in range(2, 8)],
                *[f"product2 {i}" for i in range(2, 8)],
                "error", "error wait", "error sum", "barrier", "slot sum",
                "commit")


def solve_raw(w, x, tol, max_steps, tier="fp32"):
    """A raw launch of kernel 4 (lrnde_persistent_tsit5, or its TF32
    instantiation at ``tier`` 'tf32'; saveat 0.5 and 1.0) from the
    wrapper's own start at the same tier, its grid barrier's counter zeroed
    before each launch: the kernel's device time without the wrapper's
    work."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import fused_solve, fused_tdmlp

    lib = _build_lib()
    prec = None if tier == "tf32" else "highest"
    k1_0, dt0, _ = fused_solve._start(
        lambda u, t: fused_tdmlp(w, u, t, prec), x, 0.0, 1.0, tol, tol)
    sc = fused_solve.device_scalars([0.0, 1.0, dt0], x)
    n_scratch = lib.lrnde_solve_scratch_floats(B, F, H)
    barrier = torch.zeros(1, dtype=torch.int32, device=x.device)
    fn = raw_launch(
        "lrnde_persistent_tsit5" + ("_tf32" if tier == "tf32" else ""), x,
        k1_0, sc,
        torch.tensor([0.5, 1.0], device=x.device), 2, *w,
        torch.empty_like(x), torch.empty((2, B, F), device=x.device),
        torch.empty(4, dtype=torch.int32, device=x.device),
        torch.empty(2, device=x.device), torch.empty(n_scratch, device=x.device),
        torch.empty(2 * B // 8 + 2, device=x.device), barrier, B, F, H,
        max_steps, tol, tol, 1.0 / (B * F), None, None, 0, None, None, None,
        None, None, 0, 1, None, None)

    def launch():
        barrier.zero_()
        return fn()

    return launch


def phase_solve_attribution(w, x, runs=3):
    """Kernel 4's attempt by phase at the mlp.yaml tolerance: the
    instantiation with the compile-time clock (lrnde_persistent_tsit5_timed,
    launched only here), CTA 0's %globaltimer summed over the attempts. Its
    result must be bitwise the untimed kernel's."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        fused_solve, persistent_tsit5_solve,
    )

    lib = _build_lib()
    phase_solve_cluster(w, x)
    check(lib.lrnde_solve_phases() == len(SOLVE_PHASES),
          "the kernel's phases are not SOLVE_PHASES")
    kw = dict(rtol=1.4e-8, atol=1.4e-8, max_steps=10000,
              saveat_arr=torch.tensor([0.5, 1.0], device=x.device))
    ref = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
    timing = torch.zeros(len(SOLVE_PHASES) + 1, dtype=torch.int64,
                         device=x.device)
    totals = torch.zeros(len(SOLVE_PHASES) + 1, dtype=torch.float64)
    for i in range(runs + 1):
        out = fused_solve._launch_solve(w, x, (0.0, 1.0), **kw, timing=timing)
        torch.cuda.synchronize()
        if i > 0:  # the first launch warms up
            totals += timing.cpu().double()
    attempts = int(timing[-1])
    per = (totals[:-1] / totals[-1] / 1e3).tolist()
    split = {name: round(us, 3) for name, us in zip(SOLVE_PHASES, per)}
    groups = {g: round(sum(v for k, v in split.items() if k.startswith(g)), 3)
              for g in ("input", "product1", "hidden", "product2")}
    print(f"[solve attribution] {attempts} attempts, CTA 0, µs per attempt "
          f"(mean of {runs} launches): {split}; by kind {groups}; sum "
          f"{sum(per):.3f}")
    check(all(torch.equal(out[k], ref[k]) for k in ("y_final", "ys"))
          and all(int(out[k]) == int(ref[k])
                  for k in ("naccept", "nreject", "nfe")),
          "solve attribution: the timed kernel's result differs")
    check(attempts == (int(ref["nfe"]) - 2) // 6,
          "solve attribution: attempt count")
    # the kernel alone, back to back, at both tolerances
    raws = [solve_raw(w, x, 1.4e-8, 10000), solve_raw(w, x, 1e-4, 64)]
    check(all(r() == 0 for r in raws), "solve: raw launch failed")
    ms = back_to_back_ms(raws, n=20, warmup=2)
    print(f"[solve attribution] the kernel alone, device ms per launch: "
          f"mlp.yaml {ms[0]:.4f} ({1e3 * ms[0] / attempts:.1f} µs an "
          f"attempt), bench {ms[1]:.4f}")
    return split


def rel_err(a, b):
    """max-abs difference relative to the largest magnitude of b."""
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _build_lib():
    from localregneuralde_tpu_torch.ops.cuda import _build

    return _build.load_library()


def step_bwd_raw_args(w, x, k1, sc, cts):
    """The operands of a raw ``lrnde_tsit5_step_bwd`` launch at (B, F, H)
    with fresh outputs and scratch."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda.fused_mlp_bwd import (
        weight_grad_size,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_solve_bwd import sweep_plan

    plan = sweep_plan(B, F, H)
    return (x, k1, sc, *w, *cts, torch.empty_like(x), torch.empty_like(x),
            torch.empty(weight_grad_size(F, H), device=x.device),
            torch.empty(plan.scratch_floats, device=x.device),
            torch.empty((plan.max_partials, weight_grad_size(F, H)),
                        device=x.device),
            B, F, H)


def phase_step_bwd(device, w, x, g):
    """Kernel 3 against the autograd VJP of the plain step (FP32 and FP64),
    its digest, and its time. Draws the nine cotangents from ``g``."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        fused_step_bwd, fused_step_bwd_plain, tdmlp_plain,
    )
    # against the autograd VJP of the plain step; FP32 sums in another
    # order: expect ≤ 1e-5 of the largest value
    t = torch.tensor(0.2, device=device)
    dt = torch.tensor(0.05, device=device)
    k1 = tdmlp_plain(w, x, t)
    cts = [torch.randn(x.shape, generator=g, device=device) for _ in range(9)]
    ours = fused_step_bwd(w, x, t, dt, k1, cts)
    ref = fused_step_bwd_plain(w, x, t, dt, k1, cts)
    names = ["d_u", "d_k1", "d_w1", "d_b1", "d_w2", "d_b2"]
    pairs = list(zip([ours[1], ours[2], *ours[0]], [ref[1], ref[2], *ref[0]]))
    rels = {n: rel_err(a, b) for n, (a, b) in zip(names, pairs)}
    err = max(max_abs(a, b) for a, b in pairs)
    print(f"[step_bwd] relative max-abs vs plain {rels}")
    check(max(rels.values()) <= 1e-4, f"step_bwd vs plain: {rels}")
    again = fused_step_bwd(w, x, t, dt, k1, cts)
    check(all(torch.equal(a, b) for a, b in zip(
              [*again[0], again[1], again[2]], [*ours[0], ours[1], ours[2]])),
          "step_bwd is not bitwise repeatable")
    digest("K3", *ours[0], ours[1], ours[2])
    # against the float64 VJP on the same inputs, beside the FP32 plain one
    w64 = type(w)(*[p_.double() for p_ in w])
    ref64 = fused_step_bwd_plain(w64, x.double(), t.double(), dt.double(),
                                 k1.double(), [c.double() for c in cts])
    flat64 = [ref64[1], ref64[2], *ref64[0]]
    k_err = {n: rel_err(a.double(), b) for n, a, b in
             zip(names, [ours[1], ours[2], *ours[0]], flat64)}
    p_err = {n: rel_err(a.double(), b) for n, a, b in
             zip(names, [ref[1], ref[2], *ref[0]], flat64)}
    k64 = max(k_err.values())
    print(f"[step_bwd fp64] relative max-abs vs the float64 plain VJP: "
          f"kernel {k64:.3e} {({k: f'{v:.2e}' for k, v in k_err.items()})}; "
          f"FP32 plain {max(p_err.values()):.3e} "
          f"{({k: f'{v:.2e}' for k, v in p_err.items()})}")
    check(k64 <= 2 * K3_FP64_BEFORE,
          f"step_bwd vs float64: {k64:.3e}, over 2x the old kernel's "
          f"{K3_FP64_BEFORE:.3e}")
    raw = raw_launch("lrnde_tsit5_step_bwd", *step_bwd_raw_args(
        w, x, k1, torch.stack([t, dt]), cts))
    check(raw() == 0, "step_bwd: raw launch failed")
    ms, plain = back_to_back_ms(
        [raw, lambda: fused_step_bwd_plain(w, x, t, dt, k1, cts)], n=50)
    # recompute six evaluations, transpose them (two products a stage) and
    # the stage-batched weight gradients: 18 evaluations' products
    print(f"[step_bwd] bitwise repeatable; device {ms:.4f} ms per launch, "
          f"plain {plain:.4f} ms")
    return {"tsit5_step_bwd": dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound(18 * tdmlp_flops(), 52 * B * F + 2 * tdmlp_weight_bytes()))}


def phase_backward_kernels(device, w, x):
    """The step VJP, knot recording and both sweeps against their plain
    versions at the slice's shapes."""
    import torch

    from localregneuralde_tpu_torch.ode.stored_adjoint import knot_layout
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_tdmlp, fused_tsit5_step, persistent_stored_sweep,
        persistent_stored_sweep_plain, persistent_tsit5_solve,
        persistent_two_level_sweep, persistent_two_level_sweep_plain,
    )

    # the generator's draws: K3's nine cotangents, then the sweeps'
    g = torch.Generator(device=device).manual_seed(7)
    res = phase_step_bwd(device, w, x, g)
    lib = _build_lib()

    # kernel 4 with recording, at both tolerances
    saveat = torch.tensor([0.5, 1.0], device=device)
    recs = {}
    for name, tol, max_steps in (("bench", 1e-4, 64),
                                 ("mlp.yaml", 1.4e-8, 10000)):
        dense_cap, _, stride = knot_layout(max_steps)
        kw = dict(rtol=tol, atol=tol, saveat_arr=saveat, max_steps=max_steps)
        rec_kw = dict(record_knots=True, knot_dense_cap=dense_cap,
                      knot_stride=stride)
        bare = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
        rec = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw, **rec_kw)
        n = int(rec["naccept"])
        check(n == int(bare["naccept"]) and int(rec["nfe"]) == int(bare["nfe"])
              and torch.equal(rec["y_final"], bare["y_final"])
              and torch.equal(rec["ys"], bare["ys"]),
              f"recording {name} changed the solve")
        ts = rec["knot_ts"]
        step_err = 0.0
        for j in range(n):
            u_j = rec["knot_us"][j]
            step = fused_tsit5_step(w, u_j, ts[j], ts[j + 1] - ts[j],
                                    fused_tdmlp(w, u_j, ts[j]))
            step_err = max(step_err, max_abs(step[0], rec["knot_us"][j + 1]))
        check(step_err <= 1e-5, f"knots {name} do not reconstruct: {step_err}")
        check(bool(ts[0] == 0.0) and bool(ts[n] == 1.0)
              and torch.equal(rec["knot_us"][n], rec["y_final"]),
              f"knots {name}: wrong ends")
        # checkpoints every W = 4 accepts (bench only: the checkpoint
        # buffers scale with max_steps / W)
        w4 = None
        if max_steps == 64:
            w4 = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw,
                                        record_knots=True,
                                        knot_dense_cap=dense_cap,
                                        knot_stride=4)
            check(all(torch.equal(w4["ckpt_us"][c], w4["knot_us"][4 * c])
                      for c in range(n // 4 + 1)),
                  f"checkpoints {name} differ from the dense knots")
        else:
            check(torch.equal(rec["ckpt_us"][0], x)
                  and torch.equal(rec["ckpt_ks"][0], fused_tdmlp(w, x, 0.0)),
                  f"checkpoint 0 {name} differs from (u0, k1_0)")
        rec_ms, bare_ms = median_ms(
            [lambda: persistent_tsit5_solve(w, x, (0.0, 1.0), **kw, **rec_kw),
             lambda: persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)],
            n=10, warmup=1)
        print(f"[record {name}] naccept {n}, y_final/ys/nfe bitwise equal "
              f"without recording; knots reconstruct their steps to "
              f"{step_err:.2e}; checkpoints bitwise the dense knots; "
              f"{rec_ms:.3f} ms recording vs {bare_ms:.3f} ms not")
        recs[name] = (rec, w4, kw)

    ct_ys = torch.randn((2, B, F), generator=g, device=device)
    ct_y = torch.randn((B, F), generator=g, device=device)

    def sweep_args(rec):
        return (w, rec["knot_ts"], rec["knot_us"], rec["naccept"], saveat,
                ct_ys, ct_y)

    def ckpt_args(rec):
        return tuple(rec[k] for k in ("ckpt_ts", "ckpt_us", "ckpt_ks",
                                      "ckpt_dts", "ckpt_qolds"))

    def flat(out):
        return [out[0], out[1], *out[2]]

    # kernel 7 — the dense sweep over the bench-tolerance knots
    rec = recs["bench"][0]
    dense = persistent_stored_sweep(*sweep_args(rec))
    plain_d = persistent_stored_sweep_plain(*sweep_args(rec))
    rel = max(rel_err(a, b) for a, b in zip(flat(dense), flat(plain_d)))
    err = max(max_abs(a, b) for a, b in zip(flat(dense), flat(plain_d)))
    print(f"[sweep dense] {int(rec['naccept'])} steps: relative max-abs vs "
          f"plain {rel:.3e}")
    check(rel <= 1e-4, f"dense sweep vs plain: {rel}")
    again = persistent_stored_sweep(*sweep_args(rec))
    check(all(torch.equal(a, b) for a, b in zip(flat(again), flat(dense))),
          "dense sweep is not deterministic")
    ms, plain = median_ms(
        [lambda: persistent_stored_sweep(*sweep_args(rec)),
         lambda: persistent_stored_sweep_plain(*sweep_args(rec))],
        n=10, warmup=1)
    # per step k1, six stages, their transpose and the weight gradients:
    # 19 evaluations' products; knots, saveat and final cotangents in
    n_b = int(rec["naccept"])
    res["persistent_stored_sweep"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound(19 * n_b * tdmlp_flops(),
                4 * (n_b + 1 + 3 + 2) * B * F + 2 * tdmlp_weight_bytes()))
    print(f"[sweep dense] bitwise-deterministic; {ms:.3f} ms, plain "
          f"{plain:.3f} ms")

    # kernel 8 — at the mlp.yaml tolerance with dense capacity 8 the replay
    # branch runs: one window from checkpoint 0 (W = 100)
    rec, _, kw = recs["mlp.yaml"]
    n = int(rec["naccept"])
    dense_cap, _, stride = knot_layout(10000)
    tl = dict(t_end=1.0, rtol=kw["rtol"], atol=kw["atol"], max_steps=10000,
              stride=stride)
    dense = persistent_stored_sweep(*sweep_args(rec))
    win, replay = persistent_two_level_sweep(
        *sweep_args(rec), *ckpt_args(rec), **tl, dense_cap=8,
        return_replay=True)
    check(n > 8, "the mlp.yaml solve is too short to force the replay")
    digest("K8 replay", replay[:n + 1], n)
    digest("K8 grads", *flat(win))
    check(torch.equal(replay[:n + 1], rec["knot_us"][:n + 1]),
          "the replay does not repeat the forward bitwise")
    rel = max(rel_err(a, b) for a, b in zip(flat(win), flat(dense)))
    bitwise = all(torch.equal(a, b) for a, b in zip(flat(win), flat(dense)))
    print(f"[sweep two-level] {n} accepts replayed from checkpoint 0, "
          f"bitwise equal to the dense knots; gradients vs the dense sweep: "
          f"relative max-abs {rel:.3e}, bitwise {bitwise}")
    check(rel <= 1e-6, f"two-level sweep vs dense: {rel}")
    # kernel 8 as the mlp.yaml train step runs it: dense_cap 512 ≥ n, so the
    # dense branch sweeps the recorded knots
    check(n <= dense_cap, "the mlp.yaml solve outgrew the dense knots")
    train_kw = dict(**tl, dense_cap=dense_cap)
    on_path = persistent_two_level_sweep(*sweep_args(rec), *ckpt_args(rec),
                                         **train_kw)
    check(all(torch.equal(a, b) for a, b in zip(flat(on_path), flat(dense))),
          "the dense branch of kernel 8 differs from kernel 7")
    plain_m = persistent_stored_sweep_plain(*sweep_args(rec))
    rel_m = max(rel_err(a, b) for a, b in zip(flat(on_path), flat(plain_m)))
    err_m = max(max_abs(a, b) for a, b in zip(flat(on_path), flat(plain_m)))
    check(rel_m <= 1e-4, f"dense kernel 8 vs plain: {rel_m}")
    ms, plain = median_ms(
        [lambda: persistent_two_level_sweep(*sweep_args(rec), *ckpt_args(rec),
                                            **train_kw),
         lambda: persistent_stored_sweep_plain(*sweep_args(rec))],
        n=10, warmup=1)
    res["persistent_two_level_sweep_dense"] = dict(
        max_abs_err=err_m, ms=ms, plain_ms=plain,
        **bound(19 * n * tdmlp_flops(),
                4 * (n + 1 + 3 + 2) * B * F + 2 * tdmlp_weight_bytes()))
    from localregneuralde_tpu_torch.ops.cuda.fused_solve_bwd import sweep_plan
    clusters = lib.lrnde_sweep_clusters(B, F, H)
    plan = sweep_plan(B, F, H)
    check(clusters >= 1, f"sweep cluster query failed: {clusters}")
    print(f"[sweep dense mlp.yaml] {n} steps, dense_cap {dense_cap} (the "
          f"train step's branch): relative max-abs vs plain {rel_m:.3e}; "
          f"{ms:.3f} ms, plain {plain:.3f} ms | {clusters} clusters of "
          f"{plan.cluster} CTAs resident for {len(plan.row_blocks)} row "
          f"blocks of {plan.rows}, {plan.smem_bytes} B of shared memory a CTA")
    # both sweeps against the plain sweep in float64 on the same knots
    for label, r_, out in (("K7 bench", recs["bench"][0],
                            persistent_stored_sweep(*sweep_args(
                                recs["bench"][0]))),
                           ("K8 mlp.yaml", rec, win)):
        args = sweep_args(r_)
        args64 = [type(w)(*[p_.double() for p_ in w])] + [
            a.double() if a.is_floating_point() else a for a in args[1:]]
        ref = flat(persistent_stored_sweep_plain(*args64))
        p32 = flat(persistent_stored_sweep_plain(*args))
        names = ("a_u", "a_k", "d_w1", "d_b1", "d_w2", "d_b2")
        k_err = {nm: rel_err(a.double(), b) for nm, a, b in
                 zip(names, flat(out), ref)}
        p_err = {nm: rel_err(a.double(), b) for nm, a, b in
                 zip(names, p32, ref)}
        print(f"[sweep fp64 {label}] relative max-abs vs the float64 plain "
              f"sweep: kernel {max(k_err.values()):.3e} "
              f"{ {k: f'{v:.2e}' for k, v in k_err.items()} }; FP32 plain "
              f"{max(p_err.values()):.3e} "
              f"{ {k: f'{v:.2e}' for k, v in p_err.items()} }")
        check(max(k_err.values()) <= 1e-4,
              f"sweep {label} vs float64: {k_err}")
    phase_sweep_attribution(w, rec, saveat, ct_ys, ct_y, dense)
    # against the plain two-level sweep at the bench tolerance, where the
    # plain replay takes the kernel forward's steps (stride 4, capacity 2)
    rec_b, w4, kw_b = recs["bench"]
    tl_b = dict(t_end=1.0, rtol=kw_b["rtol"], atol=kw_b["atol"], max_steps=64,
                stride=4, dense_cap=2)
    win_b = persistent_two_level_sweep(*sweep_args(w4), *ckpt_args(w4), **tl_b)
    plain_b = persistent_two_level_sweep_plain(*sweep_args(w4), *ckpt_args(w4),
                                               **tl_b)
    rel_b = max(rel_err(a, b) for a, b in zip(flat(win_b), flat(plain_b)))
    err = max(max_abs(a, b) for a, b in zip(flat(win_b), flat(plain_b)))
    print(f"[sweep two-level] bench tolerance, replay forced: relative "
          f"max-abs vs plain {rel_b:.3e}")
    check(rel_b <= 1e-3, f"two-level sweep vs plain: {rel_b}")
    ms, plain = median_ms(
        [lambda: persistent_two_level_sweep(*sweep_args(rec), *ckpt_args(rec),
                                            **tl, dense_cap=8),
         lambda: persistent_two_level_sweep_plain(
             *sweep_args(rec), *ckpt_args(rec), **tl, dense_cap=8)],
        n=5, warmup=1)
    # the window replay (six evaluations an attempt) and the sweep of its
    # n steps; one checkpoint (u, k1) in
    att = (int(rec["nfe"]) - 2) // 6
    res["persistent_two_level_sweep"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound((6 * att + 19 * n) * tdmlp_flops(),
                4 * (2 + 3 + 2) * B * F + 2 * tdmlp_weight_bytes()))
    print(f"[sweep two-level] mlp.yaml tolerance with replay: {ms:.3f} ms, "
          f"plain {plain:.3f} ms")
    return res


# adjoint_sweep.cu::SweepPhase, in order
SWEEP_PHASES = ("k1", *[f"stage {i}" for i in range(1, 7)], "seed",
                *[f"{part} {i}" for i in range(6, 0, -1)
                  for part in ("dh", "dz", "dx")],
                "dW1", "dW2", "carries")


def phase_sweep_attribution(w, rec, saveat, ct_ys, ct_y, ref, runs=3):
    """Kernel 7's (and kernel 8's dense branch's) transposed step by phase:
    the instantiation with the compile-time clock
    (lrnde_adjoint_sweep_timed, launched only here) on the mlp.yaml knots,
    CTA 0's %globaltimer summed over the steps. Its result must be bitwise
    the untimed kernel's (``ref``)."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import _build, fused_solve_bwd

    lib = _build.load_library()
    check(lib.lrnde_sweep_phases() == len(SWEEP_PHASES),
          "the kernel's phases are not SWEEP_PHASES")
    timing = torch.zeros(len(SWEEP_PHASES) + 1, dtype=torch.int64,
                         device=ct_y.device)
    totals = torch.zeros(len(SWEEP_PHASES) + 1, dtype=torch.float64)
    for i in range(runs + 1):
        out = fused_solve_bwd._launch(
            w, rec["knot_ts"], rec["knot_us"], rec["naccept"], saveat, ct_ys,
            ct_y, timing=timing)
        torch.cuda.synchronize()
        if i > 0:  # the first launch warms up
            totals += timing.cpu().double()
    steps = int(timing[-1])
    per = (totals[:-1] / totals[-1] / 1e3).tolist()
    split = {name: round(us, 3) for name, us in zip(SWEEP_PHASES, per)}
    print(f"[sweep attribution] {steps} steps, CTA 0, µs per transposed "
          f"step (mean of {runs} launches): {split}; sum {sum(per):.3f}")
    got = [out[0], out[1], *out[2]]
    want = [ref[0], ref[1], *ref[2]]
    check(all(torch.equal(a, b) for a, b in zip(got, want)),
          "sweep attribution: the timed kernel's result differs")
    check(steps == int(rec["naccept"]), "sweep attribution: step count")
    return split


def _train_setup(overrides, device, params=None, regularize="unbiased",
                 config=CONFIG):
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration, make_train_step,
    )

    cfg = define_configuration(
        overrides + [f"--model.regularize={regularize}"], config)
    model = construct_model(cfg, device=device)
    if params is not None:
        model.load_state_dict(params)
    loss_fn, w_reg = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    ts = create_train_state(model, opt)
    return model, loss_fn, make_train_step(model, loss_fn, opt), ts, w_reg, sched


def _grads(model, loss_fn, params, data, w_reg):
    """Loss, stats and parameter gradients of one training forward from a
    fresh layer state."""
    import torch

    ps = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss, _, stats = loss_fn(model, ps, model.init_state(), data, w_reg,
                             training=True)
    grads = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
    return loss, stats, dict(zip(ps, grads))


def phase_train(device, profile=False):
    """A few train steps at both tolerances, with launch counts per step and
    the first step's gradients against the plain path."""
    import torch

    from localregneuralde_tpu_torch.harness import (
        one_hot, synthetic_classification, warmup_model,
    )
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    x_train, y_train, _, _ = synthetic_classification((28, 28), 1, 10, seed=0)
    batches = [
        (torch.tensor(x_train[i * B:(i + 1) * B], device=device),
         torch.tensor(one_hot(y_train[i * B:(i + 1) * B], 10), device=device))
        for i in range(TRAIN_STEPS)
    ]
    runs = []
    for name, overrides in TOLERANCES:
        model, loss_fn, step, ts, w_reg, sched = _train_setup(overrides, device)
        params0 = {k: v.detach().clone() for k, v in ts.params.items()}
        warmup_model(step, None, ts, batches[0], w_reg(1), sched(1))
        runs.append((name, overrides, model, loss_fn, step, ts, w_reg, sched,
                     params0))
    torch.cuda.synchronize()

    # --- the training path: every launch from here to launch_counts() counts
    reset_launch_counts()
    results = []
    per_step = []
    for name, overrides, model, loss_fn, step, ts, w_reg, sched, _ in runs:
        for i, data in enumerate(batches):
            before = launch_counts()
            t0 = time.perf_counter()
            ts, loss, stats = step(ts, data, w_reg(i + 1), sched(i + 1))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            after = launch_counts()
            per_step.append((name, {k: after[k] - before[k] for k in after}))
            results.append((name, i, loss, stats, ms))
    counts = tier_counts()

    sweep_of = {"mlp.yaml": "persistent_two_level_sweep",
                "bench": "persistent_stored_sweep"}
    for (name, i, loss, stats, ms), (_, c) in zip(results, per_step):
        nfe = int(stats["nfe"])
        reg = float(stats["reg_val"])
        print(f"[train {name}] step {i}: loss {float(loss):.6f} reg_val "
              f"{reg:.6e} nfe {nfe} success {bool(stats['solver_success'])} "
              f"{ms:.3f} ms {nfe / (ms / 1e3):.1f} dynamics evals/s | "
              f"launches {c}")
        check(bool(torch.isfinite(loss)) and reg > 0 and reg < float("inf")
              and bool(stats["solver_success"])
              and tuple(stats["y_pred"].shape) == (B, 10),
              f"train {name} step {i}: bad output")
        want = {"persistent_tsit5_solve": 1, "tsit5_step": 1,
                "tsit5_step_bwd": 1, sweep_of[name]: 1, "tdmlp": 4}
        check(all(c[k] == v for k, v in want.items())
              and sum(c.values()) == sum(want.values()),
              f"train {name} step {i}: launches {c}, expected {want}")
    print(f"[train] launch counts {counts}")

    # --- the first step's gradients against the plain path, on the card
    # and (8 images) on the CPU. The CPU computes at the card's tiers
    # (tiers_of), so it is a reference at the same tiers; the card's plain
    # route computes the reference's FP32 gradient products behind an FP32
    # forward (mlp.yaml), so there the gradients cross tiers (grads_tol).
    # Every pair is compared whatever its NFE: at mlp.yaml's rtol the two
    # solves agree far below the gates whatever their steps, and at the
    # bench's both run TF32, whose steps differ anyway (logits_tol)
    for name, overrides, model, loss_fn, _, _, w_reg, _, params0 in runs:
        sd = model.state_dict()
        small = (batches[0][0][:8], batches[0][1][:8])
        plain = _train_setup(overrides + ["--model.use_pallas=off"], device, sd)
        cpu = _train_setup(overrides, "cpu", {k: v.cpu() for k, v in sd.items()})
        ours_t = node_tiers(model, device)
        for where, data, ref_model, ref_loss, ref_dev in (
            ("the card's plain path", batches[0], plain[0], plain[1], device),
            ("the CPU at the card's tiers, 8 images", small, cpu[0], cpu[1],
             "cpu"),
        ):
            ref_t = node_tiers(ref_model, device)
            ref_params = {k: v.to(ref_dev) for k, v in params0.items()}
            ref_data = tuple(d.to(ref_dev) for d in data)
            # the gradient of the cross-entropy alone (w_reg = 0), and of
            # the whole loss
            g = {}
            for part, wr in (("ce", 0.0), ("loss", w_reg(1))):
                with tiers_of(device):
                    g[part] = (_grads(model, loss_fn, params0, data, wr),
                               _grads(ref_model, ref_loss, ref_params,
                                      ref_data, wr))
            (_, s_ours, g_ours), (_, s_ref, g_ref) = g["ce"]
            n_ours, n_ref = int(s_ours["nfe"]), int(s_ref["nfe"])
            ce_ours = float(s_ours["ce_loss"].detach())
            ce_ref = float(s_ref["ce_loss"].detach())
            g_tol = grads_tol(ours_t, ref_t)
            # the classifier computes at TF32 on both sides: the logits,
            # and so the cross-entropy, part by its TF32 rounding (and a
            # TF32 forward's), cross_entropy_tol, at least CE_TOL
            c_tol = cross_entropy_tol(ours_t, ref_t, s_ref["y_pred"])
            rel = max(rel_err(g_ours[k].cpu(), g_ref[k].cpu()) for k in g_ours)
            (_, _, gl_ours), (_, _, gl_ref) = g["loss"]
            rel_l = max(rel_err(gl_ours[k].cpu(), gl_ref[k].cpu())
                        for k in gl_ours)
            print(f"[train {name}] first step vs {where}: NFE {n_ours} vs "
                  f"{n_ref}, cross-entropy {ce_ours:.6f} vs {ce_ref:.6f} "
                  f"(tolerance {c_tol:.3e}), reg_val "
                  f"{float(s_ours['reg_val'].detach()):.6e} vs "
                  f"{float(s_ref['reg_val'].detach()):.6e}; tiers ours "
                  f"{'/'.join(ours_t)}, reference {'/'.join(ref_t)} "
                  f"(forward/gradients); gradients of the cross-entropy "
                  f"relative max-abs {rel:.3e} (tolerance {g_tol:.3e}); of "
                  f"the loss with the regulariser {rel_l:.3e} (reg_val's "
                  f"error estimate is rounding noise here)")
            check(abs(ce_ours - ce_ref) <= c_tol,
                  f"train {name}: cross-entropy disagrees with {where}")
            check(rel <= g_tol,
                  f"train {name}: gradients disagree with {where}")
    # --- the replay branch through the model: --model.solver.knot_window=8
    # at the mlp.yaml tolerance (~25 accepts) makes the stored adjoint
    # replay from the checkpoints; the replay repeats the forward, so the
    # gradients equal those of the dense branch
    name, overrides, model, loss_fn, _, _, w_reg, _, params0 = runs[0]
    windowed = _train_setup(overrides + ["--model.solver.knot_window=8"],
                            device, model.state_dict())
    _, s_d, g_d = _grads(model, loss_fn, params0, batches[0], w_reg(1))
    _, s_w, g_w = _grads(windowed[0], windowed[1], params0, batches[0],
                         w_reg(1))
    rel = max(rel_err(g_w[k], g_d[k]) for k in g_d)
    bitwise = all(torch.equal(g_w[k], g_d[k]) for k in g_d)
    print(f"[train {name}] knot_window 8 (replay) vs 512 (dense): NFE "
          f"{int(s_w['nfe'])} vs {int(s_d['nfe'])}, gradients relative "
          f"max-abs {rel:.3e}, bitwise {bitwise}")
    check(int(s_w["nfe"]) == int(s_d["nfe"]) and rel <= 1e-6,
          f"train {name}: the replayed sweep disagrees with the dense one")
    if profile:
        _profile_train(runs, batches)
    return counts


def _profile_train(runs, batches):
    """Device time by kernel over three train steps per tolerance."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for name, _, _, _, step, ts, w_reg, sched, _ in runs:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(3):
                ts, loss, _ = step(ts, batches[i], w_reg(1), sched(1))
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 3
        # device kernels only: the CPU-side ops report their kernels' time
        # again
        rows = [(e.key, e.device_time_total / 1e3 / 3, e.count / 3)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        print(f"[profile {name}] {wall:.3f} ms per train step, device busy "
              f"{busy:.3f} ms ({100 * busy / wall:.1f}%)")
        for key, ms, cnt in rows[:14]:
            print(f"[profile {name}]   {ms:9.3f} ms  x{cnt:6.1f}  {key[:90]}")


def _sde_model(device, overrides=(), params=None):
    """The MNIST-SDE model of SDE_CONFIG with random weights from its seed,
    its loss and its train state."""
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, create_train_state,
        define_configuration,
    )

    cfg = define_configuration(list(overrides), SDE_CONFIG)
    model = construct_model(cfg, device=device)
    if params is not None:
        model.load_state_dict(params)
    loss_fn, w_reg = construct_loss(cfg)
    return model, loss_fn, create_train_state(model), w_reg


def _mnist_batches(device, n, train=False):
    import torch

    from localregneuralde_tpu_torch.harness import (
        one_hot, synthetic_classification,
    )

    x_tr, y_tr, x_te, y_te = synthetic_classification((28, 28), 1, 10, seed=0)
    xs, ys = (x_tr, y_tr) if train else (x_te, y_te)
    return [(torch.tensor(xs[i * B:(i + 1) * B], device=device),
             torch.tensor(one_hot(ys[i * B:(i + 1) * B], 10), device=device))
            for i in range(n)]


def phase_sde_kernels(device, ode_w, ode_x):
    """Kernels 10 and 12 against their plain versions at the MNIST-SDE
    width on the layer's real input (the downsampled images), and kernel
    4's reservoir against the plain loop."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        SDEWeights, persistent_sde_solve, persistent_sde_solve_plain,
        persistent_sde_sweep, persistent_sde_sweep_plain,
        persistent_tsit5_solve, persistent_tsit5_solve_plain,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
        diffusion_plain, drift_plain,
    )
    from localregneuralde_tpu_torch.sde import (
        PhiloxNormals, get_sri_tableau, sri_step,
    )

    res = {}
    model, _, _, _ = _sde_model(device)
    node = model.neural_dsde
    w = SDEWeights(*(p.detach() for p in
                     list(node.drift.parameters())
                     + list(node.diffusion.parameters())))
    u0 = _sde_input(model, _mnist_batches(device, 1)[0][0])
    Fs = u0.shape[1]
    saveat = torch.tensor([0.5, 1.0], device=device)
    kw = dict(noise=PhiloxNormals(1234, B, Fs, device=device), rtol=SDE_TOL,
              atol=SDE_TOL, solver="sosri", delta=1 / 6, saveat_arr=saveat,
              max_steps=10000, record_knots=True)

    # kernel 10 — same seed, so the same Brownian path: the uniforms are
    # bitwise equal, the normals differ by the tails' logf, and the step
    # times by the error norm's summation order
    out = persistent_sde_solve(w, u0, (0.0, 1.0), **kw)
    digest("K10", out)
    ref = persistent_sde_solve_plain(w, u0, (0.0, 1.0), **kw)
    na, nb = int(out["naccept"]), int(ref["naccept"])
    ta, tb = int(out["natt"]), int(ref["natt"])
    err = max_abs(out["ys"], ref["ys"])
    print(f"[sde solve] kernel {na} accepts / {ta} attempts, loop {nb} / "
          f"{tb}; ys max-abs {err:.3e}, y_final max-abs "
          f"{max_abs(out['y_final'], ref['y_final']):.3e}")
    check(bool(out["success"]) and bool(ref["success"]),
          "sde solve: not successful")
    check(abs(na - nb) <= 2 and abs(ta - tb) <= 2,
          f"sde solve: step counts {na}/{ta} vs {nb}/{tb}")
    # a Hölder-1/2 path: a step time one ulp apart moves W by ~2e-4
    # (tests/test_torch_sde.py), so with equal counts the states agree to
    # 1e-3 (measured 1.0e-5); after an ulp-level accept flip the two step
    # sequences still solve the same path, and y_final is held to 5e-2
    yf_err = max_abs(out["y_final"], ref["y_final"])
    if ta == tb:
        check(max(err, yf_err) <= 1e-3,
              f"sde solve vs plain: ys max-abs {err}, y_final {yf_err}")
    else:
        check(yf_err <= 5e-2, f"sde solve vs plain after an accept flip: "
              f"y_final max-abs {yf_err}")
    n = na
    ts = out["knot_ts"][: n + 1]
    tab = get_sri_tableau("sosri")
    step_err = 0.0
    for j in range(n):
        st = sri_step(lambda u, t: drift_plain(w, u),
                      lambda u, t: diffusion_plain(w, u), out["knot_us"][j],
                      ts[j], ts[j + 1] - ts[j], out["knot_dws"][j],
                      out["knot_dzs"][j], SDE_TOL, SDE_TOL, 1 / 6, tab)
        step_err = max(step_err, max_abs(st.u_new, out["knot_us"][j + 1]))
    check(step_err <= 1e-4, f"sde knots do not reconstruct: {step_err}")
    check(float(ts[0]) == 0.0 and float(ts[n]) == 1.0
          and torch.equal(out["knot_us"][n], out["y_final"]),
          "sde knots: wrong ends")
    again = persistent_sde_solve(w, u0, (0.0, 1.0), **kw)
    check(int(again["natt"]) == ta and torch.equal(again["ys"], out["ys"])
          and torch.equal(again["knot_dws"][:n], out["knot_dws"][:n]),
          "sde solve is not deterministic")
    dts = (ts[1:] - ts[:-1]).reshape(-1, 1, 1)
    moments = []
    for name in ("knot_dws", "knot_dzs"):
        z = out[name][:n] / torch.sqrt(dts)
        moments.append((float(z.mean()), float((z * z).mean())))
    print(f"[sde solve] knots reconstruct their steps to {step_err:.2e}; "
          f"bitwise deterministic; increments over √dt: dW mean "
          f"{moments[0][0]:.4f} var {moments[0][1]:.4f}, dZ mean "
          f"{moments[1][0]:.4f} var {moments[1][1]:.4f} "
          f"({n * B * Fs} samples each)")
    check(all(abs(m) < 0.01 and abs(v - 1) < 0.03 for m, v in moments),
          f"sde increments are not N(0, dt): {moments}")
    call, plain = median_ms(
        [lambda: persistent_sde_solve(w, u0, (0.0, 1.0), **kw),
         lambda: persistent_sde_solve_plain(w, u0, (0.0, 1.0), **kw)],
        n=3, warmup=1)
    wrapped, = back_to_back_ms(
        [lambda: persistent_sde_solve(w, u0, (0.0, 1.0), **kw)], n=20,
        warmup=2)
    ms = phase_sde_solve_attribution(w, u0, kw, out)
    print(f"[sde solve] kernel {ms:.4f} ms per raw launch back to back "
          f"({1e3 * ms / ta:.2f} µs per attempt; before the redesign "
          f"{PARENT_MS.get('K10')}), {wrapped:.3f} ms per wrapper call back "
          f"to back, one call {call:.3f} ms; loop {plain:.3f} ms")
    # four drift and four diffusion evaluations an attempt; out ys, y_final
    # and the knots (u, dW, dZ). The products alone, and with the Brownian
    # tree's draws: (depth + 1) a (column pair, row) an attempt
    mlp_sde = 2 * B * (2 * Fs * 64 + Fs * Fs)
    nbytes = 4 * ((1 + 3 + 3 * n + 1) * B * Fs
                  + 2 * Fs * 64 + 64 + Fs * Fs + 2 * Fs)
    products = bound(4 * ta * mlp_sde, nbytes)
    tree = tree_bound(ta * 25 * B * (-(-Fs // 2)), 4 * ta * mlp_sde, nbytes)
    print(f"[sde solve] bound: products only {products['bound_ms']:.5f} ms "
          f"(share {100 * products['bound_ms'] / ms:.2f}%), with the tree's "
          f"draws {tree['bound_ms']:.5f} ms (share "
          f"{100 * tree['bound_ms'] / ms:.2f}%; the kernels line's)")
    res["persistent_sde_solve"] = dict(max_abs_err=err, ms=ms,
                                       plain_ms=plain, **tree)

    # kernel 12 — on kernel 10's own knots
    g = torch.Generator(device=device).manual_seed(11)
    args = (out["knot_ts"], out["knot_us"], out["knot_dws"], out["knot_dzs"],
            out["naccept"], saveat,
            torch.randn((2, B, Fs), generator=g, device=device),
            torch.randn((B, Fs), generator=g, device=device))
    sw = dict(solver="sosri", delta=1 / 6)
    ours = persistent_sde_sweep(w, *args, **sw)
    digest("K12 state", ours[0])
    digest("K12 grads", *ours[1])
    plain_s = persistent_sde_sweep_plain(w, *args, **sw)
    flat = lambda o: [o[0], *o[1]]  # noqa: E731
    # the weight gradients' FP64 error: against the plain sweep in float64
    # on the same knots, beside the FP32 plain sweep
    args64 = tuple(a_.double() if a_.is_floating_point() else a_
                   for a_ in args)
    ref64 = flat(persistent_sde_sweep_plain(
        SDEWeights(*(p_.double() for p_ in w)), *args64, **sw))
    k64 = [rel_err(a_.double(), b_) for a_, b_ in zip(flat(ours), ref64)]
    p64 = [rel_err(a_.double(), b_) for a_, b_ in zip(flat(plain_s), ref64)]
    print(f"[sde sweep fp64] relative max-abs vs the float64 plain sweep: "
          f"weight gradients kernel {max(k64[1:]):.3e}, FP32 plain "
          f"{max(p64[1:]):.3e}; a_u kernel {k64[0]:.2e}, FP32 plain "
          f"{p64[0]:.2e}")
    check(K12_FP64_BEFORE is None or max(k64[1:]) <= 2 * K12_FP64_BEFORE,
          f"sde sweep vs float64: {max(k64[1:]):.3e}, over 2x the old "
          f"kernel's {K12_FP64_BEFORE}")
    phase_sde_sweep_attribution(w, args, ours, device)
    rel = max(rel_err(a, b) for a, b in zip(flat(ours), flat(plain_s)))
    err = max(max_abs(a, b) for a, b in zip(flat(ours), flat(plain_s)))
    again = persistent_sde_sweep(w, *args, **sw)
    bitwise = all(torch.equal(a, b) for a, b in zip(flat(again), flat(ours)))
    print(f"[sde sweep] {n} steps: relative max-abs vs plain {rel:.3e}, "
          f"bitwise deterministic {bitwise}")
    check(rel <= 1e-4, f"sde sweep vs plain: {rel}")
    check(bitwise, "sde sweep is not deterministic")
    call, plain = median_ms(
        [lambda: persistent_sde_sweep(w, *args, **sw),
         lambda: persistent_sde_sweep_plain(w, *args, **sw)], n=5, warmup=1)
    ms, = back_to_back_ms([lambda: persistent_sde_sweep(w, *args, **sw)],
                          n=20, warmup=2)
    print(f"[sde sweep] kernel {ms:.3f} ms per call back to back "
          f"({ms / n:.4f} ms per step; before the redesign "
          f"{PARENT_MS['K12']}), one call {call:.3f} ms; plain {plain:.3f} ms")
    # per step the stages' recompute, their transpose and the weight
    # gradients (three times the step's products); knots and cotangents in
    res["persistent_sde_sweep"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound(12 * n * mlp_sde,
                4 * ((3 * n + 1 + 3 + 1) * B * Fs
                     + 2 * (2 * Fs * 64 + 64 + Fs * Fs + 2 * Fs))))

    # kernel 4's reservoir — the sample is the start of an accepted step.
    # Without rejects, accept k decides on uniform k, so the uniforms alone
    # name the step: the last k with u[k]·(k + 1) < 1. Each side is held to
    # that step. The step times are not compared: at rtol 1e-4 the first
    # step's error norm is f32 rounding noise, so the second step's dt
    # differs between the kernel, the cuBLAS loop and a float64 loop
    # (printed; the float64 loop shows the f32 times' spread is noise)
    u = torch.rand(64, generator=torch.Generator().manual_seed(3)).to(device)
    okw = dict(rtol=1e-4, atol=1e-4, max_steps=64, record_knots=True)
    picks = []
    for name, solve, dtype in (
            ("kernel", persistent_tsit5_solve, torch.float32),
            ("loop", persistent_tsit5_solve_plain, torch.float32),
            ("float64 loop", persistent_tsit5_solve_plain, torch.float64)):
        o = solve(type(ode_w)(*(t.to(dtype) for t in ode_w)), ode_x.to(dtype),
                  (0.0, 1.0), saveat_arr=torch.ones(1, dtype=dtype,
                                                    device=device),
                  reservoir=u.to(dtype), **okw)
        n, nrej = int(o["naccept"]), int(o["nreject"])
        kts = o["knot_ts"][: n + 1]
        res_t = o["reservoir_t"].to(kts.dtype)  # the loop records f32 times
        j = int(torch.argmin((kts[:n] - res_t).abs()))
        check(float(kts[j]) == float(res_t) < 1.0
              and torch.equal(o["knot_us"][j], o["reservoir_u"]),
              f"reservoir ({name}): not the start of an accepted step")
        k = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        want = int(torch.nonzero(u[:n] * k < 1.0).max())
        check(nrej > 0 or j == want,
              f"reservoir ({name}): step {j}, the uniforms pick {want}")
        picks.append((n, nrej, j))
        print(f"[reservoir] {name}: step {j} of {n} accepts, {nrej} rejects "
              f"(the uniforms pick {want} without rejects); knot times "
              f"{[round(float(v), 6) for v in kts]}")
    if picks[0][:2] == picks[1][:2]:
        check(picks[0][2] == picks[1][2], f"reservoir picks differ: {picks}")
    okw.update(saveat_arr=torch.ones(1, device=device), reservoir=u)
    bare = dict(okw, reservoir=None)
    with_res, without = back_to_back_ms(
        [lambda: persistent_tsit5_solve(ode_w, ode_x, (0.0, 1.0), **okw),
         lambda: persistent_tsit5_solve(ode_w, ode_x, (0.0, 1.0), **bare)],
        n=20, warmup=2)
    print(f"[reservoir] kernel 4 recording at rtol 1e-4: {with_res:.3f} ms per "
          f"call with the reservoir, {without:.3f} ms without")
    return res


def _sde_raw_args(w, u0, kw, tier="fp32"):
    """Kernel 10's C operands as persistent_sde_solve passes them at the
    product ``tier`` (knots recorded, no reservoir), the first drift
    evaluation and the dt heuristic run here, once; without the stream.
    Returns the arguments, the grid barrier and the output buffers by the
    wrapper's names."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import _build
    from localregneuralde_tpu_torch.ops.cuda import fused_sde_solve as fs

    Bs, Fs = u0.shape
    dev, m = u0.device, kw["max_steps"]
    new = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=dev)
    saveat = kw["saveat_arr"]
    dt = fs.initial_dt(u0, fs.drift_plain(w, u0, tier), kw["rtol"],
                       kw["atol"], 0.0, 1.0)
    n_blocks = -(-Bs // _build.load_library().lrnde_sde_rows_per_block())
    out = dict(y_final=new(Bs, Fs), ys=new(saveat.shape[0], Bs, Fs),
               stats_i=new(4, dtype=torch.int32), stats_f=new(2),
               knot_ts=new(m + 1), knot_us=new(m + 1, Bs, Fs),
               knot_dws=new(m, Bs, Fs), knot_dzs=new(m, Bs, Fs))
    wz = new(2, 2, Bs, Fs)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    args = [int(kw["solver"] == "sosri"), u0,
            fs.device_scalars([0.0, 1.0, dt], u0), saveat, saveat.shape[0],
            *w, kw["noise"].seed_word(dev), 24, out["y_final"], out["ys"],
            out["stats_i"], out["stats_f"], new(Bs, Fs), wz[0], wz[1],
            new(2 * n_blocks), bar, None, None, out["knot_ts"],
            out["knot_us"], out["knot_dws"], out["knot_dzs"], Bs, Fs,
            w.b1.shape[0], m, kw["rtol"], kw["atol"], kw["delta"],
            1.0 / (Bs * Fs)]
    return args, bar, out


def phase_sde_solve_attribution(w, u0, kw, ref, runs=3):
    """Kernel 10's attempt by phase: the instantiation with the compile-time
    clock (lrnde_sde_solve_timed, launched only here), CTA 0's %globaltimer
    summed over the attempts, bitwise the untimed kernel (outputs, knots and
    step counts) and of its attempt count; then the untimed kernel as a raw
    launch back to back. Returns its device ms per call."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    check(lib.lrnde_sde_phases() == len(SDE_PHASES),
          "the kernel's phases are not SDE_PHASES")
    args, bar, out = _sde_raw_args(w, u0, kw)
    n = int(ref["naccept"])

    def same():
        return (torch.equal(out["y_final"], ref["y_final"])
                and torch.equal(out["ys"], ref["ys"])
                and int(out["stats_i"][0]) == n
                and int(out["stats_i"][3]) == int(ref["natt"])
                and all(torch.equal(out[k][:n + 1], ref[k][:n + 1])
                        for k in ("knot_ts", "knot_us"))
                and all(torch.equal(out[k][:n], ref[k][:n])
                        for k in ("knot_dws", "knot_dzs")))

    def timed(tm):
        bar.zero_()
        return raw_launch("lrnde_sde_solve_timed", *args, tm)()

    err, per, natt, _ = _clocked(timed, len(SDE_PHASES), u0.device, runs)
    check(err == 0, "sde solve attribution: launch failed")
    check(same(), "sde solve attribution: the timed kernel's result differs")
    check(natt == int(ref["natt"]), "sde solve attribution: attempt count")
    split = {k: round(v, 3) for k, v in zip(SDE_PHASES, per)}
    print(f"[sde solve attribution] {natt} attempts, CTA 0, µs per attempt "
          f"(mean of {runs} launches): {split}; sum {sum(per):.3f}; bitwise "
          f"the untimed kernel")
    raw = raw_launch("lrnde_sde_solve", *args)
    check((bar.zero_(), raw())[1] == 0 and same(),
          "sde solve: the raw launch differs from the wrapper's")
    ms, = back_to_back_ms([lambda: (bar.zero_(), raw())[1]], n=20, warmup=2)
    return ms


def _sde_sweep_raw(w, args, device):
    """Kernel 12's C operands after its tiers (SOSRI) as
    persistent_sde_sweep passes them, without the stream; returns them
    with the a_u and flat gradient outputs."""
    import torch

    lib = _build_lib()
    knot_ts, knot_us, knot_dws, knot_dzs, naccept, saveat, ct_ys, ct_y = args
    Bs, Fs = ct_y.shape
    Hs = w.b1.shape[0]
    n_grad = lib.lrnde_sde_grad_floats(Fs, Hs)
    a_u = torch.empty_like(ct_y)
    d_w = torch.empty(n_grad, device=device)
    part = torch.empty((-(-Bs // lib.lrnde_sde_rows_per_block()), n_grad),
                       device=device)
    nacc = naccept.to(device=device, dtype=torch.int32).reshape(1)
    raw = (1, *w, knot_ts, knot_us, knot_dws, knot_dzs, nacc, saveat,
           saveat.shape[0], ct_ys, ct_y, a_u, d_w, part, Bs, Fs, Hs)
    return raw, a_u, d_w


def phase_sde_sweep_attribution(w, args, ref, device, runs=3):
    """Kernel 12's step by phase: the instantiation with the compile-time
    clock (lrnde_sde_sweep_timed, launched only here), CTA 0's
    %globaltimer summed over the steps, bitwise the untimed kernel; then
    the untimed launch split into the sweep and its partials' sum."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    names = _phase_names(lib, "lrnde_sde_sweep_phase_names")
    raw, a_u, d_w = _sde_sweep_raw(w, args, device)
    timed = lambda timing: raw_launch(  # noqa: E731
        "lrnde_sde_sweep_timed", *raw, timing)()
    err, per, steps, _ = _clocked(timed, len(names), device, runs)
    check(err == 0, "sde sweep attribution: launch failed")
    check(torch.equal(a_u, ref[0]) and torch.equal(
        d_w, torch.cat([g.reshape(-1) for g in ref[1]])),
        "sde sweep attribution: the timed kernel's result differs")
    split = {n_: round(us, 3) for n_, us in zip(names, per)}
    print(f"[sde sweep attribution] {steps} steps, CTA 0, µs per step (the "
          f"partial write: per step of the sweep) (mean of {runs} launches): "
          f"{split}; sum {sum(per):.3f}; bitwise the untimed kernel")
    untimed = raw_launch("lrnde_sde_sweep", 0, *raw)
    ms, = back_to_back_ms([untimed], n=20, warmup=2)
    sequence_split("sde sweep attribution launches", untimed,
                   lambda name, seen: ("partial sums" if "reduce_partials"
                                       in name else "sweep"), ms)
    return split


def phase_sde_serving(device):
    """The MNIST-SDE serving path: three eval batches through
    make_eval_step, with launch counts; logits against the plain path."""
    import torch

    from localregneuralde_tpu_torch.harness import make_eval_step
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    batches = _mnist_batches(device, N_BATCHES)
    model, loss_fn, ts, w_reg = _sde_model(device)
    tiers = node_tiers(model, device)
    # the loss logs the drift NFE in both slots (the reference's quirk), so
    # the diffusion NFE is read from the layer's own state
    layer = []

    def loss_reading_layer(*args, **kw):
        loss, st_, stats = loss_fn(*args, **kw)
        layer.append(st_["neural_dsde"])
        return loss, st_, stats

    step = make_eval_step(model, loss_reading_layer)
    step(ts, batches[0], w_reg(1))  # first-call set-up
    torch.cuda.synchronize()
    ts.state = model.init_state()
    layer.clear()

    # --- the main path: every launch from here to launch_counts() counts
    reset_launch_counts()
    results = []
    for i, data in enumerate(batches):
        t0 = time.perf_counter()
        loss, stats = step(ts, data, w_reg(1))
        torch.cuda.synchronize()
        results.append((loss, stats, 1e3 * (time.perf_counter() - t0)))
    counts = launch_counts()
    for i, ((loss, stats, ms), st) in enumerate(zip(results, layer)):
        nfe, nfe_g = int(st["nfe_drift"]), int(st["nfe_diffusion"])
        ok = bool(stats["solver_success"])
        print(f"[sde serve] batch {i}: loss {float(loss):.6f} nfe drift "
              f"{nfe} diffusion {nfe_g} success {ok} {ms:.3f} ms "
              f"{B / (ms / 1e3):.1f} images/s")
        check(ok and bool(torch.isfinite(loss))
              and tuple(stats["y_pred"].shape) == (B, 10)
              and bool(torch.isfinite(stats["y_pred"]).all())
              and int(stats["nfe"][0]) == nfe and nfe_g == nfe - 1,
              f"sde serve batch {i}: bad output")
    by_tier = tier_counts()
    print(f"[sde serve] launch counts {counts}; kernel 10 by tier "
          f"{by_tier['persistent_sde_solve[' + tiers[0] + ']']} at "
          f"{tiers[0]}")
    check(counts["persistent_sde_solve"] == N_BATCHES
          and sum(counts.values()) == N_BATCHES
          and by_tier[f"persistent_sde_solve[{tiers[0]}]"] == N_BATCHES,
          "the SDE kernel did not run once per batch, alone, at its tier")

    # the first batch again on the plain path (same seed, same noise), and
    # 8 images on the card against the CPU
    sd = model.state_dict()
    plain = _sde_model(device, ["--model.use_pallas=off"], sd)
    ours = make_eval_step(model, loss_fn)(_fresh(ts, model), batches[0],
                                          w_reg(1))[1]
    ref = make_eval_step(plain[0], plain[1])(plain[2], batches[0], w_reg(1))[1]
    err = max_abs(ours["y_pred"], ref["y_pred"])
    rel = rel_err(ours["y_pred"], ref["y_pred"])
    same_path = int(ours["nfe"][0]) == int(ref["nfe"][0])
    # the same accepts on the same Brownian path: the logits part by the
    # TF32 rounding of the outer layers and of one evaluation (logits_tol)
    tol, _ = logits_tol(tiers, node_tiers(plain[0], device), **SDE_DEPTHS)
    print(f"[sde serve] batch 0 logits vs the plain path max-abs {err:.3e}, "
          f"relative {rel:.3e} (tolerance {tol:.3e} on the same steps), nfe "
          f"{int(ours['nfe'][0])} vs {int(ref['nfe'][0])}")
    check(rel <= tol if same_path else err <= 5e-2,
          f"sde serve: logits disagree with the plain path: {err}")
    cpu = _sde_model("cpu", [], {k: v.cpu() for k, v in sd.items()})
    xs, ys = batches[0][0][:8], batches[0][1][:8]
    on_card = make_eval_step(model, loss_fn)(_fresh(ts, model), (xs, ys),
                                             w_reg(1))[1]
    with tiers_of(device):
        on_cpu = make_eval_step(cpu[0], cpu[1])(cpu[2], (xs.cpu(), ys.cpu()),
                                                w_reg(1))[1]
    err = max_abs(on_card["y_pred"].cpu(), on_cpu["y_pred"])
    print(f"[sde serve] 8 images, card kernel vs CPU plain at the card's "
          f"tiers ({'/'.join(tiers)}): logits max-abs {err:.3e}, nfe "
          f"{int(on_card['nfe'][0])} vs {int(on_cpu['nfe'][0])}")
    check(err <= 5e-2, "sde serve: card disagrees with the CPU")
    return by_tier


def _fresh(ts, model):
    """``ts`` with the layer state (and its generator) of a new model."""
    import dataclasses

    return dataclasses.replace(ts, state=model.init_state())


def phase_sde_train(device, profile=False):
    """Five train steps each with the unbiased and the biased regulariser,
    with launches per step, and the first step's gradients against the
    plain path."""
    import torch

    from localregneuralde_tpu_torch.harness import warmup_model
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    batches = _mnist_batches(device, TRAIN_STEPS, train=True)
    runs = []
    for mode in ("unbiased", "biased"):
        model, loss_fn, step, ts, w_reg, sched = _train_setup(
            [], device, regularize=mode, config=SDE_CONFIG)
        params0 = {k: v.detach().clone() for k, v in ts.params.items()}
        warmup_model(step, None, ts, batches[0], w_reg(1), sched(1))
        runs.append((mode, model, loss_fn, step, ts, w_reg, sched, params0))
    torch.cuda.synchronize()

    # --- the training path: every launch from here to launch_counts() counts
    reset_launch_counts()
    for mode, model, loss_fn, step, ts, w_reg, sched, _ in runs:
        for i, data in enumerate(batches):
            before = launch_counts()
            t0 = time.perf_counter()
            ts, loss, stats = step(ts, data, w_reg(i + 1), sched(i + 1))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            after = launch_counts()
            c = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            nfe = int(stats["nfe"][0])
            reg = float(stats["reg_val"])
            print(f"[sde train {mode}] step {i}: loss {float(loss):.6f} "
                  f"reg_val {reg:.6e} nfe drift {nfe} success "
                  f"{bool(stats['solver_success'])} {ms:.3f} ms | launches "
                  f"{c} (the sweep's call includes its partials' sum)")
            check(bool(torch.isfinite(loss)) and 0 < reg < float("inf")
                  and bool(stats["solver_success"]),
                  f"sde train {mode} step {i}: bad output")
            check(c == {"persistent_sde_solve": 1, "persistent_sde_sweep": 1},
                  f"sde train {mode} step {i}: launches {c}")
    counts = tier_counts()
    print(f"[sde train] launch counts {counts}")

    # the first step's cross-entropy gradients against the plain path on
    # the card: the same seed gives the same Brownian path
    for mode, model, loss_fn, _, _, w_reg, _, params0 in runs:
        plain = _train_setup(["--model.use_pallas=off"], device,
                             model.state_dict(), regularize=mode,
                             config=SDE_CONFIG)
        _, s_o, g_o = _grads(model, loss_fn, params0, batches[0], 0.0)
        _, s_r, g_r = _grads(plain[0], plain[1], params0, batches[0], 0.0)
        rel = max(rel_err(g_o[k], g_r[k]) for k in g_o)
        same_path = int(s_o["nfe"][0]) == int(s_r["nfe"][0])
        g_tol = grads_tol(node_tiers(model, device),
                          node_tiers(plain[0], device), **SDE_DEPTHS)
        print(f"[sde train {mode}] first step vs the card's plain path: NFE "
              f"{int(s_o['nfe'][0])} vs {int(s_r['nfe'][0])}, cross-entropy "
              f"{float(s_o['ce_loss'].detach()):.6f} vs "
              f"{float(s_r['ce_loss'].detach()):.6f}, "
              f"reg_val {float(s_o['reg_val'].detach()):.6e} vs "
              f"{float(s_r['reg_val'].detach()):.6e}; cross-entropy gradients "
              f"relative max-abs {rel:.3e} (tolerance {g_tol:.3e} on the "
              f"same steps)")
        # the same accepts give the same path up to the error norm's
        # summation order (measured 5.5e-7 at FP32) and, at TF32, one
        # swept step's TF32 rounding (grads_tol); an accept flip moves it
        # more
        check(rel <= (g_tol if same_path else 5e-2),
              f"sde train {mode}: gradients disagree with plain: {rel}")
    if profile:
        _profile_train([(r[0], None, None, None, r[3], r[4], r[5], r[6], None)
                        for r in runs], batches)
    return counts


def phase_ode_biased(device):
    """One biased training step of the ODE at rtol 1e-4: the persistent
    solve with the reservoir, the sweep, and the regulariser's step."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    batches = _mnist_batches(device, 1, train=True)
    model, loss_fn, step, ts, w_reg, sched = _train_setup(
        BENCH, device, regularize="biased")
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    ts, loss, stats = step(ts, batches[0], w_reg(1), sched(1))
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    reg = float(stats["reg_val"])
    print(f"[ode biased] loss {float(loss):.6f} reg_val {reg:.6e} nfe "
          f"{int(stats['nfe'])} {ms:.3f} ms (first call) | launches "
          f"{ {k: v for k, v in counts.items() if v} }")
    want = {"persistent_tsit5_solve": 1, "tsit5_step": 1, "tsit5_step_bwd": 1,
            "persistent_stored_sweep": 1, "tdmlp": 4}
    check(bool(torch.isfinite(loss)) and 0 < reg < float("inf")
          and all(counts[k] == v for k, v in want.items())
          and sum(counts.values()) == sum(want.values()),
          f"ode biased step: launches {counts}, reg_val {reg}")
    return tier_counts()


def _latent_setup(device, overrides=(), params=None):
    """The PhysioNet latent ODE of LATENT_CONFIG with random weights from
    its seed (or ``params``), its loss, its data splits and grid."""
    import torch

    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_time_series, define_configuration,
    )
    from localregneuralde_tpu_torch.harness.latent_runner import (
        build_physionet_arrays,
    )

    cfg = define_configuration(list(overrides), LATENT_CONFIG)
    train, test, tgrid, _ = build_physionet_arrays(cfg)
    model = construct_time_series(cfg, saveat=torch.from_numpy(tgrid),
                                  device=device)
    if params is not None:
        model.load_state_dict(params)
    return cfg, model, construct_loss(cfg), train, test, tgrid


def _host_batch(arrays, device, n=B, shuffle=False):
    """The first batch of n series as the runner's loader gives it."""
    import torch

    from localregneuralde_tpu_torch.harness import make_dataloader

    loader = make_dataloader(arrays, n, shuffle=shuffle, cycle=True, seed=0)
    return tuple(torch.from_numpy(a).to(device) for a in next(iter(loader)))


def chain_inputs(device):
    """Kernels 5 and 9's inputs at the PhysioNet width: the chain of
    LATENT_CONFIG's model (random weights from its seed) and the eval-mode
    latent states of the first 512 training series, with the training
    solve's saveat (the 49-point grid, whose first time is t0, and the
    regulariser's t1, appended unsorted). Returns (params, chain, u0,
    saveat, latents(arrays, n), the test split, the grid)."""
    import torch

    _, model, _, train, test, tgrid = _latent_setup(device)
    node = model.neural_ode

    def latents(arrays, n):
        """The eval-mode latent states of the first n series, the encoder
        and rec_to_gen (the backend default: TF32 on the card) at the CPU's
        tiers (``tiers_of("cpu")``), so the digests keep the inputs they
        were taken on."""
        x = torch.cat(_host_batch(arrays, device, n=n), dim=-1)
        with torch.no_grad(), tiers_of("cpu"):
            st = model.init_state()
            h = model.gru(x, st["gru"])[0]
            h = model.rec_to_gen(h, st["rec_to_gen"])[0]
            return model.reparam(h, st["reparam"])[0].contiguous()

    saveat = torch.cat([torch.from_numpy(tgrid), torch.tensor([0.37])]).to(
        device)
    return ([p.detach() for p in node.chain_params()], node.chain,
            latents(train, B), saveat, latents, test, tgrid)


def chain_flops(dims, b=B):
    """Product FLOPs of one Dense-chain evaluation of b rows."""
    return 2 * b * sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))


def phase_chain_kernels(device):
    """Kernels 5 and 9 against their plain versions at the PhysioNet width,
    on the encoder's latent states of 512 training series."""
    import torch

    from localregneuralde_tpu_torch.ode.step import tsit5_step
    from localregneuralde_tpu_torch.ode.stored_adjoint import knot_layout
    from localregneuralde_tpu_torch.ops.cuda import (
        chain_eval, persistent_chain_solve, persistent_chain_solve_plain,
        persistent_chain_sweep, persistent_chain_sweep_plain,
    )

    params, chain, u0, saveat, latents, test, tgrid = chain_inputs(device)
    Fc = u0.shape[1]
    n_save = saveat.shape[0]
    print(f"[chain] B = {u0.shape[0]}, dims {chain.dims}, lead tanh "
          f"{chain.lead}, {n_save} saveat times")
    _print_chain_grids(chain, u0.shape[0], test[0].shape[0])
    res, res_4 = {}, None
    for name, tol in (("rtol 1e-4", 1e-4), ("physionet.yaml", LATENT_TOL)):
        kw = dict(rtol=tol, atol=tol, saveat_arr=saveat, max_steps=10000)
        out = persistent_chain_solve(params, chain, u0, (0.0, 1.0), **kw)
        res_4 = out if tol == 1e-4 else res_4
        digest(f"K5 {name}", out)
        ref = persistent_chain_solve_plain(params, chain, u0, (0.0, 1.0), **kw)
        na, nb = int(out["naccept"]), int(ref["naccept"])
        fa, fb = int(out["nfe"]), int(ref["nfe"])
        err = max_abs(out["ys"], ref["ys"])
        print(f"[chain solve {name}] kernel naccept {na} nreject "
              f"{int(out['nreject'])} nfe {fa} | loop naccept {nb} nreject "
              f"{int(ref['nreject'])} nfe {fb} | ys max-abs {err:.3e}")
        check(bool(out["success"]) and bool(ref["success"]),
              f"chain solve {name}: not successful")
        check(torch.equal(out["ys"][0], u0), "chain solve: the t0 entry")
        if tol == 1e-4:
            # FP32 sums in another order: step for step up to an ulp-level
            # accept flip
            check(err <= 2e-4 and abs(na - nb) <= 1 and abs(fa - fb) <= 12,
                  f"chain solve {name} disagrees with the loop")
        else:
            # below the f32 noise of ũ the step counts follow each side's
            # summation order (ROADMAP Queue 3): a band, as for kernel 4
            check(err <= 1e-4 and 0.75 <= na / nb <= 1.34,
                  f"chain solve {name} disagrees with the loop")
    a = persistent_chain_solve(params, chain, u0, (0.0, 1.0), **kw)
    check(torch.equal(a["ys"], out["ys"]) and int(a["nfe"]) == fa,
          "chain solve is not deterministic")
    solve_err = err

    # the eval path's own shape: the whole test split (410 series, so the
    # last row block is partial) on the 49-point grid, as for the B = 512
    # solve at the config's tolerance
    u_ev = latents(test, test[0].shape[0])
    kw_ev = dict(kw, saveat_arr=torch.from_numpy(tgrid).to(device))
    out_ev = persistent_chain_solve(params, chain, u_ev, (0.0, 1.0), **kw_ev)
    digest("K5 eval", out_ev)
    ref_ev = persistent_chain_solve_plain(params, chain, u_ev, (0.0, 1.0),
                                          **kw_ev)
    na_ev, nb_ev = int(out_ev["naccept"]), int(ref_ev["naccept"])
    err_ev = max_abs(out_ev["ys"], ref_ev["ys"])
    print(f"[chain solve eval] B = {u_ev.shape[0]}, {len(tgrid)} saveat "
          f"times: kernel naccept {na_ev} nfe {int(out_ev['nfe'])} | loop "
          f"naccept {nb_ev} nfe {int(ref_ev['nfe'])} | ys max-abs "
          f"{err_ev:.3e}")
    check(bool(out_ev["success"]) and bool(ref_ev["success"])
          and torch.equal(out_ev["ys"][0], u_ev)
          and err_ev <= 1e-4 and 0.75 <= na_ev / nb_ev <= 1.34,
          "chain solve at the eval shape disagrees with the loop")
    solve_err = max(solve_err, err_ev)

    # the training forward: recording with the stored adjoint's layout
    dense_cap, _, stride = knot_layout(10000)
    rec_kw = dict(kw, record_knots=True, knot_dense_cap=dense_cap,
                  knot_stride=stride)
    rec = persistent_chain_solve(params, chain, u0, (0.0, 1.0), **rec_kw)
    n = int(rec["naccept"])
    check(n == na and int(rec["nfe"]) == fa
          and torch.equal(rec["ys"], out["ys"])
          and torch.equal(rec["y_final"], out["y_final"]),
          "chain recording changed the solve")
    f = lambda u, t, s: (chain_eval(params, chain, u), s)  # noqa: E731
    ts = rec["knot_ts"]
    step_err = 0.0
    for j in range(n):
        u = rec["knot_us"][j]
        stp = tsit5_step(f, u, ts[j], ts[j + 1] - ts[j], f(u, 0, None)[0], None)
        step_err = max(step_err, max_abs(stp.u_new, rec["knot_us"][j + 1]))
    check(step_err <= 1e-5 and float(ts[0]) == 0.0 and float(ts[n]) == 1.0
          and torch.equal(rec["knot_us"][n], rec["y_final"])
          and torch.equal(rec["ckpt_us"][0], u0),
          f"chain knots do not reconstruct their steps: {step_err}")
    print(f"[chain record] {n} accepts; ys, y_final and NFE bitwise equal "
          f"without recording; knots reconstruct their steps to "
          f"{step_err:.2e}; bitwise deterministic")

    # kernel 9 on kernel 5's own knots
    g = torch.Generator(device=device).manual_seed(13)
    ct_ys = torch.randn((n_save, u0.shape[0], Fc), generator=g, device=device)
    ct_y = torch.randn(u0.shape, generator=g, device=device)
    args = (params, chain, rec["knot_ts"], rec["knot_us"], rec["naccept"],
            saveat, ct_ys, ct_y)
    ctx = {k: rec[k] for k in rec if k.startswith("ckpt_")}
    ctx.update(t_end=1.0, rtol=LATENT_TOL, atol=LATENT_TOL, max_steps=10000,
               stride=stride, dense_cap=dense_cap)
    flat = lambda o: [o[0], o[1], *o[2]]  # noqa: E731
    dense = persistent_chain_sweep(*args, two_level_ctx=ctx)
    plain = persistent_chain_sweep_plain(*args, two_level_ctx=ctx)
    rel = max(rel_err(p, q) for p, q in zip(flat(dense), flat(plain)))
    sweep_err = max(max_abs(p, q) for p, q in zip(flat(dense), flat(plain)))
    again = persistent_chain_sweep(*args, two_level_ctx=ctx)
    bitwise = all(torch.equal(p, q) for p, q in zip(flat(again), flat(dense)))
    print(f"[chain sweep dense] {n} steps: relative max-abs vs plain "
          f"{rel:.3e}, bitwise deterministic {bitwise}")
    check(rel <= 1e-4 and bitwise, f"chain sweep vs plain: {rel}")
    # the two-level branch, forced with a dense capacity of 8: the replay
    # repeats kernel 5's windows bitwise
    check(n > 8, "the chain solve is too short to force the replay")
    win, replay = persistent_chain_sweep(*args, two_level_ctx=dict(
        ctx, dense_cap=8), return_replay=True)
    m = min(n, stride)
    digest("K9 replay", replay[:m + 1])
    digest("K9 state", win[0], win[1])
    digest("K9 grads", *win[2])
    check(torch.equal(replay[:m + 1], rec["knot_us"][:m + 1]),
          "the chain replay does not repeat the forward bitwise")
    rel_w = max(rel_err(p, q) for p, q in zip(flat(win), flat(dense)))
    print(f"[chain sweep two-level] {n} accepts replayed from "
          f"{(n - 1) // stride + 1} checkpoint(s), bitwise equal to the "
          f"dense knots; gradients vs the dense branch relative max-abs "
          f"{rel_w:.3e}, bitwise "
          f"{all(torch.equal(p, q) for p, q in zip(flat(win), flat(dense)))}")
    check(rel_w <= 1e-6, f"chain two-level sweep vs dense: {rel_w}")

    # the weight gradients' FP64 error: the dense branch against the plain
    # sweep in float64 on the same knots, beside the FP32 plain sweep
    args64 = ([p_.double() for p_ in params], chain) + tuple(
        a_.double() if a_.is_floating_point() else a_ for a_ in args[2:])
    ref64 = flat(persistent_chain_sweep_plain(*args64))
    k64 = [rel_err(a_.double(), b_) for a_, b_ in zip(flat(dense), ref64)]
    p64 = [rel_err(a_.double(), b_) for a_, b_ in zip(flat(plain), ref64)]
    sweep_fp64 = max(k64[2:])
    print(f"[chain sweep fp64] relative max-abs vs the float64 plain sweep: "
          f"weight gradients kernel {sweep_fp64:.3e}, FP32 plain "
          f"{max(p64[2:]):.3e}; a_u, a_k kernel {k64[0]:.2e}, {k64[1]:.2e}, "
          f"FP32 plain {p64[0]:.2e}, {p64[1]:.2e}")
    check(K9_FP64_BEFORE is None or sweep_fp64 <= 2 * K9_FP64_BEFORE,
          f"chain sweep vs float64: {sweep_fp64:.3e}, over 2x the old "
          f"kernel's {K9_FP64_BEFORE}")
    phase_chain_attribution(params, chain, u0, rec_kw, rec, args)

    # device times: the kernel alone (raw launches) at the recorded
    # training forward, the eval batch and rtol 1e-4; the sweep's two
    # branches back to back; one wrapper call of each between CUDA events
    raws = [chain_raw(params, chain, u0, saveat, LATENT_TOL, record=True),
            chain_raw(params, chain, u_ev, kw_ev["saveat_arr"], LATENT_TOL),
            chain_raw(params, chain, u0, saveat, 1e-4)]
    check(all(r() == 0 for r in raws), "chain solve: raw launch failed")
    raw_ms = back_to_back_ms(raws, n=20, warmup=2)
    solve = lambda: persistent_chain_solve(  # noqa: E731
        params, chain, u0, (0.0, 1.0), **rec_kw)
    sweep = lambda: persistent_chain_sweep(  # noqa: E731
        *args, two_level_ctx=ctx)
    sweep_tl = lambda: persistent_chain_sweep(  # noqa: E731
        *args, two_level_ctx=dict(ctx, dense_cap=8))
    sweep_b2b, tl_b2b = back_to_back_ms([sweep, sweep_tl], n=20, warmup=2)
    solve_call, sweep_call = median_ms([solve, sweep], n=10, warmup=1)
    solve_plain, sweep_plain = median_ms(
        [lambda: persistent_chain_solve_plain(params, chain, u0, (0.0, 1.0),
                                              **rec_kw),
         lambda: persistent_chain_sweep_plain(*args, two_level_ctx=ctx)],
        n=3, warmup=1)
    att = (fa - 2) // 6
    att_ev = (int(out_ev["nfe"]) - 2) // 6
    att_4 = (int(res_4["nfe"]) - 2) // 6
    solve_b2b = raw_ms[0]
    print(f"[chain solve] the kernel alone, device ms per launch: "
          f"physionet.yaml recording {raw_ms[0]:.4f} ({1e3 * raw_ms[0] / att:.2f}"
          f" µs an attempt, {att} attempts), eval B = {u_ev.shape[0]} "
          f"{raw_ms[1]:.4f} ({1e3 * raw_ms[1] / att_ev:.2f} µs, {att_ev}), "
          f"rtol 1e-4 {raw_ms[2]:.4f} ({1e3 * raw_ms[2] / att_4:.2f} µs, "
          f"{att_4}); one wrapper call {solve_call:.3f} ms; loop "
          f"{solve_plain:.3f} ms")
    print(f"[chain sweep] kernel {sweep_b2b:.3f} ms per call back to back "
          f"({1e3 * sweep_b2b / n:.2f} µs per step), two-level (replay forced,"
          f" dense_cap 8) {tl_b2b:.3f} ms; one call {sweep_call:.3f} ms; "
          f"plain {sweep_plain:.3f} ms")
    n_params = sum(p.numel() for p in params)
    BF = u0.numel()
    # in u0, k1_0 and the weights; out ys, y_final, the knots and the
    # checkpoints (u, k1) written
    res["persistent_chain_solve"] = dict(
        max_abs_err=solve_err, ms=solve_b2b, plain_ms=solve_plain,
        call_ms=solve_call,
        **bound(6 * att * chain_flops(chain.dims),
                4 * ((2 + n_save + 1 + n + 1 + 2 * (n // stride + 1)) * BF
                     + n_params)))
    # per step k1, six stages, their transpose and the weight gradients
    # (19 evaluations' products); in the knots, the cotangents and the
    # weights, out a_u, a_k and the gradients
    res["persistent_chain_sweep"] = dict(
        max_abs_err=sweep_err, ms=sweep_b2b, plain_ms=sweep_plain,
        call_ms=sweep_call,
        **bound(19 * n * chain_flops(chain.dims),
                4 * ((n + 1 + n_save + 1 + 2) * BF + 2 * n_params)))
    return res


def _print_chain_grids(chain, *batches):
    """Kernels 5 and 9's grids at each batch size, from the library
    (``lrnde_chain_solve_grid``, ``lrnde_chain_sweep_grid``), held against
    the plan model of ``fused_solve.chain_plan`` at the library's J."""
    import ctypes

    from localregneuralde_tpu_torch.ops.cuda import fused_solve

    lib = _build_lib()
    L = len(chain.dims) - 1
    dims = (ctypes.c_int * (L + 1))(*chain.dims)
    dp = ctypes.cast(dims, ctypes.c_void_p)
    for b in batches:
        out = (ctypes.c_int * 2)()
        op = ctypes.cast(out, ctypes.c_void_p)
        check(lib.lrnde_chain_solve_grid(dp, L, b, op) == 0,
              "the chain solve's grid query failed")
        j5, g5 = out[0], out[1]
        grids = []
        for tl in (0, 1):
            check(lib.lrnde_chain_sweep_grid(dp, L, b, tl, op) == 0,
                  "the chain sweep's grid query failed")
            grids.append((out[0], out[1]))
        check(fused_solve.chain_smem_floats(chain.dims, 1)
              == lib.lrnde_chain_solve_smem_floats(dp, L)
              and fused_solve.chain_smem_floats(chain.dims, 1, sweep=True)
              == lib.lrnde_chain_sweep_smem_floats(dp, L),
              "the chain kernels' shared memory differs from chain_plan's")
        smem5 = 4 * fused_solve.chain_smem_floats(chain.dims, j5)
        smem9 = 4 * fused_solve.chain_smem_floats(chain.dims, 1, sweep=True)
        print(f"[chain grid] B = {b}: kernel 5 {g5} CTAs of {j5} error "
              f"block(s) ({smem5} B of shared memory a CTA); kernel 9 dense "
              f"{grids[0][1]} CTAs, two-level {grids[1][1]} CTAs of "
              f"{grids[1][0]} ({smem9} B a CTA at one block)")


def chain_raw(params, chain, u, saveat, tol, record=False, tier="fp32"):
    """A raw launch of kernel 5 (lrnde_persistent_chain, or at the TF32
    ``tier`` lrnde_persistent_chain_tf32; max_steps 10000) from the
    wrapper's own start, with the stored adjoint's recording when
    ``record``, its grid barrier's counter zeroed before each launch: the
    kernel's device time without the wrapper's work."""
    import torch

    from localregneuralde_tpu_torch.ode.stored_adjoint import knot_layout
    from localregneuralde_tpu_torch.ops.cuda import chain_eval, fused_solve

    Bc, Fc = u.shape
    dev = u.device
    k1_0, dt0, _ = fused_solve._start(
        lambda x, t: chain_eval(params, chain, x, tier), u, 0.0, 1.0, tol,
        tol)
    sc = fused_solve.device_scalars([0.0, 1.0, dt0], u)
    knots, stride = {}, 1
    if record:
        dense_cap, _, stride = knot_layout(10000)
        knots = fused_solve._knot_outputs(u, 10000, record_knots=True,
                                          knot_dense_cap=dense_cap,
                                          knot_stride=stride)
    n_dense = knots["knot_ts"].shape[0] if knots else 0
    n_ckpt = knots["ckpt_ts"].shape[0] if "ckpt_ts" in knots else 0
    n_save = saveat.shape[0]
    barrier = torch.zeros(1, dtype=torch.int32, device=dev)
    fn = raw_launch(
        "lrnde_persistent_chain" + ("_tf32" if tier == "tf32" else ""), u,
        k1_0, sc, saveat.contiguous(), n_save,
        *fused_solve.chain_operands(params, chain), torch.empty_like(u),
        torch.empty((n_save, Bc, Fc), device=dev),
        torch.empty(4, dtype=torch.int32, device=dev),
        torch.empty(2, device=dev),
        torch.empty(2 * -(-Bc // 4) + 2, device=dev), barrier, Bc, 10000,
        tol, tol, 1.0 / (Bc * Fc), knots.get("knot_ts"), knots.get("knot_us"),
        n_dense, knots.get("ckpt_ts"), knots.get("ckpt_us"),
        knots.get("ckpt_ks"), knots.get("ckpt_dts"), knots.get("ckpt_qolds"),
        n_ckpt, stride, None, None)

    def launch():
        barrier.zero_()
        return fn()

    return launch


def _phase_names(lib, query):
    """The attribution phases of a clocked instantiation, as the library
    names them (a comma-separated C string)."""
    import ctypes

    fn = getattr(lib, query)
    fn.argtypes, fn.restype = [], ctypes.c_char_p
    return fn().decode().split(",")


def _clocked(launch, n_phases, device, runs=3):
    """Run a clocked launch ``runs + 1`` times (the first warms up) into a
    timing buffer of n_phases nanosecond sums, a count and, past them, each
    CTA's SM index + 1 where the kernel records it; returns (the last
    launch's result, µs per counted unit by phase, the count, the CTAs on
    the busiest SM and the SMs used, or None)."""
    import torch

    timing = torch.zeros(n_phases + 1 + 1024, dtype=torch.int64,
                         device=device)
    totals = torch.zeros(n_phases + 1, dtype=torch.float64)
    for i in range(runs + 1):
        out = launch(timing)
        torch.cuda.synchronize()
        if i > 0:
            totals += timing[:n_phases + 1].cpu().double()
    sms = [v for v in timing[n_phases + 1:].tolist() if v]
    spread = (max(sms.count(v) for v in sms), len(set(sms))) if sms else None
    return (out, (totals[:-1] / totals[-1] / 1e3).tolist(),
            int(timing[n_phases]), spread)


def phase_chain_attribution(params, chain, u0, rec_kw, rec, args, runs=3):
    """Kernel 5's attempt and kernel 9's dense step by phase at
    physionet.yaml (B = 512): the instantiations with the compile-time
    clock (lrnde_persistent_chain_timed, lrnde_chain_sweep_timed, launched
    only here), CTA 0's %globaltimer summed over the attempts or steps, in
    the library's own phases. Each result must be bitwise its untimed
    kernel's. Then kernel 9's launches by kernel (the sweep and the fold of
    its partials) from torch.profiler."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        fused_solve, fused_solve_bwd, persistent_chain_sweep,
    )

    lib = _build_lib()
    names = _phase_names(lib, "lrnde_chain_solve_phase_names")
    out, per, attempts, spread = _clocked(
        lambda tm: fused_solve._launch_chain(params, chain, u0, (0.0, 1.0),
                                             **rec_kw, timing=tm),
        len(names), u0.device, runs)
    split = {k: round(v, 3) for k, v in zip(names, per)}
    print(f"[chain solve attribution] {attempts} attempts, CTA 0, µs per "
          f"attempt (mean of {runs} launches): {split}; sum {sum(per):.3f}"
          + (f"; at most {spread[0]} CTA(s) an SM, {spread[1]} SMs"
             if spread else ""))
    # the knots past naccept and the checkpoints past naccept / stride are
    # never written
    n = int(rec["naccept"])
    n_ck = n // rec_kw["knot_stride"] + 1
    written = dict(y_final=None, ys=None, knot_ts=None, knot_us=n + 1,
                   ckpt_ts=n_ck, ckpt_us=n_ck, ckpt_ks=n_ck)
    check(all(torch.equal(out[k][:m], rec[k][:m]) for k, m in written.items())
          and all(int(out[k]) == int(rec[k])
                  for k in ("naccept", "nreject", "nfe")),
          "chain solve attribution: the timed kernel's result differs")
    check(attempts == (int(rec["nfe"]) - 2) // 6,
          "chain solve attribution: attempt count")
    names = _phase_names(lib, "lrnde_chain_sweep_phase_names")
    ref = persistent_chain_sweep(*args)
    got, per, steps, spread = _clocked(
        lambda tm: fused_solve_bwd._launch_chain_sweep(*args, timing=tm),
        len(names), u0.device, runs)
    split = {k: round(v, 3) for k, v in zip(names, per)}
    print(f"[chain sweep attribution] {steps} steps, CTA 0, µs per step "
          f"(mean of {runs} launches): {split}; sum {sum(per):.3f}"
          + (f"; at most {spread[0]} CTA(s) an SM, {spread[1]} SMs"
             if spread else ""))
    check(all(torch.equal(a, b) for a, b in
              zip([got[0], got[1], *got[2]], [ref[0], ref[1], *ref[2]])),
          "chain sweep attribution: the timed kernel's result differs")
    check(steps == int(rec["naccept"]), "chain sweep attribution: step count")
    kernel_split("persistent_chain_sweep",
                 lambda: persistent_chain_sweep(*args), n=5, top=4)


def phase_latent(device, profile=False):
    """physionet.yaml as shipped through the port's latent runner: three
    train steps and one eval pass, with launches per step and per eval
    batch (by tier: kernel 5 FP32, kernel 9's gradient products TF32, the
    reference's grad_precision=None); then the first step's gradients
    against the plain path and the eval MSE against the CPU at the card's
    tiers. Returns the launch counts with tiers."""
    import tempfile

    import torch

    from localregneuralde_tpu_torch.harness import (
        define_configuration, latent_runner,
    )
    from localregneuralde_tpu_torch.nn import product_tier
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    steps, evals, probes = [], [], []
    make, evaluate = latent_runner.make_train_step, latent_runner.eval_forward
    make_probes = latent_runner.make_phase_probes

    def delta(before):
        after = launch_counts()
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    def timed_make(*a, **kw):
        step = make(*a, **kw)

        def timed(ts, batch, w, lr):
            torch.cuda.synchronize()
            before, t0 = launch_counts(), time.perf_counter()
            ts, loss, stats = step(ts, batch, w, lr)
            torch.cuda.synchronize()
            steps.append((1e3 * (time.perf_counter() - t0), delta(before),
                          loss, stats))
            return ts, loss, stats

        return timed

    def timed_eval(model, ts, batch, *dp):
        torch.cuda.synchronize()
        before, t0 = launch_counts(), time.perf_counter()
        mse, nfe = evaluate(model, ts, batch, *dp)
        torch.cuda.synchronize()
        evals.append((1e3 * (time.perf_counter() - t0), delta(before),
                      float(mse), int(nfe), int(batch[0].shape[0])))
        return mse, nfe

    def counted_probes(*a, **kw):
        measure = make_probes(*a, **kw)

        def counted(ts, batch, w):
            before = launch_counts()
            out = measure(ts, batch, w)
            probes.append(delta(before))
            return out

        return counted

    latent_runner.make_train_step = timed_make
    latent_runner.eval_forward = timed_eval
    latent_runner.make_phase_probes = counted_probes
    try:
        with tempfile.TemporaryDirectory() as tmp:
            cfg = define_configuration([
                f"--train.total_steps={LATENT_STEPS}",
                "--train.print_frequency=1",
                f"--train.evaluate_every={LATENT_STEPS}",
                f"--train.checkpoint_dir={tmp}/ckpt",
                f"--train.log_dir={tmp}/logs",
            ], LATENT_CONFIG)
            torch.cuda.synchronize()
            # --- the main path: every launch from here to launch_counts()
            reset_launch_counts()
            summary = latent_runner.run_latent_ode_experiment(cfg, "physionet")
            counts = tier_counts()
    finally:
        latent_runner.make_train_step = make
        latent_runner.eval_forward = evaluate
        latent_runner.make_phase_probes = make_probes

    want = {"persistent_chain_solve": 1, "persistent_chain_sweep": 1}
    for i, (ms, c, loss, stats) in enumerate(steps):
        nfe = int(stats["nfe"])
        print(f"[latent train] step {i + 1}: {ms:.3f} ms, nfe {nfe}, "
              f"{nfe / (ms / 1e3):.1f} dynamics evals/s | loss "
              f"{float(loss):.6f} nll {float(stats['neg_log_likelihood']):.6f}"
              f" kl {float(stats['kl_div']):.6f} reg_val "
              f"{float(stats['reg_val']):.6e} success "
              f"{bool(stats['solver_success'])} | launches {c}")
        check(bool(torch.isfinite(loss)) and bool(stats["solver_success"])
              and 0 < float(stats["reg_val"]) < float("inf"),
              f"latent train step {i + 1}: bad output")
        check(c == want, f"latent train step {i + 1}: launches {c}, "
              f"expected {want}")
    for ms, c, mse, nfe, bs in evals:
        print(f"[latent eval] batch of {bs}: masked MSE {mse:.6f}, nfe {nfe}, "
              f"{ms:.3f} ms, {bs / (ms / 1e3):.1f} series/s | launches {c}")
        check(c == {"persistent_chain_solve": 1} and mse == mse,
              f"latent eval: launches {c}, mse {mse}")
    check(len(steps) == LATENT_STEPS and len(evals) == 1
          and abs(summary["final_eval_mse"] - evals[0][2])
          <= 1e-12 * evals[0][2],
          f"latent runner: {len(steps)} steps, {len(evals)} eval batches, "
          f"summary {summary}")
    print(f"[latent] runner summary {summary}; launch counts "
          f"{ {k: v for k, v in counts.items() if v} }; the phase probes' "
          f"(a forward and a forward with its backward, each twice, once a "
          f"print window) {probes}")
    # the probes run the step body's kernels: two forwards and two forwards
    # with their backward
    probe = {"persistent_chain_solve": 4, "persistent_chain_sweep": 2}
    check(len(probes) == LATENT_STEPS and all(c == probe for c in probes),
          f"latent: the phase probes' launches {probes}, expected {probe} "
          f"once a window")
    grad = product_tier(None, device)
    check(counts.get(f"persistent_chain_sweep[fp32/fp32/{grad}]", 0)
          == LATENT_STEPS + 2 * len(probes)
          and counts.get("persistent_chain_solve[fp32]", 0)
          == LATENT_STEPS + 1 + 4 * len(probes),
          f"latent: kernel 5 at FP32 and kernel 9 at fp32/fp32/{grad}: "
          f"{counts}")

    # the first step's gradients against the plain path on the card, with
    # the same draws (t1 and ε from the same seeds); w_reg = 0: at the
    # config's tolerance the regulariser is f32 noise (ROADMAP Queue 3)
    from localregneuralde_tpu_torch.harness.latent_runner import eval_forward

    for name, over in (("rtol 1e-4", ["--model.solver.reltol=1e-4",
                                      "--model.solver.abstol=1e-4"]),
                       ("physionet.yaml", [])):
        _, model, (loss_fn, _), train, test, _ = _latent_setup(device, over)
        sd = model.state_dict()
        _, plain_model, (plain_loss, _), _, _, _ = _latent_setup(
            device, over + ["--model.use_pallas=off"], sd)
        batch = _host_batch(train, device, shuffle=True)
        params = {k: v.detach() for k, v in model.named_parameters()}
        w = (0.0, 0.5)
        _, s_o, g_o = _grads(model, loss_fn, params, batch, w)
        _, s_r, g_r = _grads(plain_model, plain_loss, params, batch, w)
        n_o, n_r = int(s_o["nfe"]), int(s_r["nfe"])
        nll_o = float(s_o["neg_log_likelihood"].detach())
        nll_r = float(s_r["neg_log_likelihood"].detach())
        # at 'auto' rtol 1e-4 resolves to the TF32 forward on both routes
        # (kernel 5 and 9 at TF32, the plain chain at TF32): the two part
        # by one evaluation's TF32 rounding (the cross-entropy's rule), and
        # TF32's noise in ũ may set their steps apart; kernel 9's gradient
        # products are TF32 at either tolerance, the plain route's the
        # forward's: one transposed step's TF32 rounding (grads_tol)
        tiers, p_tiers = node_tiers(model, device), node_tiers(plain_model,
                                                               device)
        tf32_fwd = tiers[0] == "tf32"
        nll_tol = (max(1e-5, 2 * logits_tol(tiers, p_tiers,
                                            **LATENT_DEPTHS)[0])
                   if tf32_fwd else 1e-5)
        head = (f"[latent train {name}] ({'/'.join(tiers)} vs "
                f"{'/'.join(p_tiers)}) first step vs the card's plain path:"
                f" NFE {n_o} vs {n_r}, NLL {nll_o:.6f} vs {nll_r:.6f}, "
                f"reg_val {float(s_o['reg_val'].detach()):.6e} vs "
                f"{float(s_r['reg_val'].detach()):.6e}")
        check(abs(nll_o - nll_r) <= nll_tol * max(1.0, abs(nll_r)),
              f"latent {name}: NLL disagrees with the plain path")
        if n_o != n_r:
            check(name != "rtol 1e-4" or tf32_fwd,
                  f"latent {name}: NFE {n_o} vs {n_r}")
            print(f"{head}; the step sequences differ (f32 or TF32 noise in "
                  f"the error estimate), gradients not compared")
            continue
        rel = max(rel_err(g_o[k], g_r[k]) for k in g_o)
        g_tol = grads_tol(tiers, p_tiers, **LATENT_DEPTHS)
        print(f"{head}; gradients of NLL + 0.5 KL relative max-abs {rel:.3e}"
              f" (tolerance {g_tol:.3e})")
        check(rel <= g_tol, f"latent {name}: gradients disagree: {rel}")
    # 8 test series: the card's kernel path against the CPU at the card's
    # tiers (physionet.yaml: the encoder and decoder at TF32)
    cpu = _latent_setup("cpu", [], {k: v.cpu() for k, v in sd.items()})[1]
    _latent_vs_cpu("[latent eval]", model, cpu,
                   _host_batch(test, device, n=8), device)
    if profile:
        _profile_latent(device)
    return counts


def _latent_eval(model, batch):
    """(masked MSE, NFE, predictions) of one eval-mode batch
    (``latent_runner.eval_forward``'s, and the model's output)."""
    import torch

    from localregneuralde_tpu_torch.harness import create_train_state
    from localregneuralde_tpu_torch.harness.latent_runner import eval_forward

    ts = create_train_state(model)
    mse, nfe = eval_forward(model, ts, batch)
    with torch.no_grad():
        y, _ = torch.func.functional_call(
            model, ts.params, (torch.cat(batch, dim=-1), ts.state),
            {"training": False})
    return float(mse), int(nfe), y


def _latent_vs_cpu(tag, model, cpu, batch, device):
    """One eval batch on the card against the CPU model at the card's tiers
    (``tiers_of``): the predictions within one evaluation's TF32 rounding
    of the layers at TF32 (``logits_tol`` at LATENT_DEPTHS) on the same
    steps, else 5e-2; the masked MSE within twice that (1e-4 at least).
    Returns the card's (MSE, NFE)."""
    mse_c, nfe_c, y_c = _latent_eval(model, batch)
    with tiers_of(device):
        mse_h, nfe_h, y_h = _latent_eval(cpu, tuple(a.cpu() for a in batch))
    tiers = node_tiers(model, device)
    tol, _ = logits_tol(tiers, node_tiers(cpu, device), **LATENT_DEPTHS)
    same = nfe_c == nfe_h
    err = rel_err(y_c.cpu(), y_h)
    d_mse = abs(mse_c - mse_h) / mse_h
    print(f"{tag} {batch[0].shape[0]} series ({'/'.join(tiers)}), card "
          f"kernel vs CPU plain at the card's tiers: masked MSE {mse_c:.7f} "
          f"vs {mse_h:.7f} (relative {d_mse:.3e}, tolerance "
          f"{max(1e-4, 2 * tol):.3e}), nfe {nfe_c} vs {nfe_h}, predictions "
          f"relative max-abs {err:.3e} (tolerance {tol:.3e} on the same "
          f"steps, else 5e-2)")
    check(d_mse <= max(1e-4, 2 * tol) and err <= (tol if same else 5e-2),
          f"{tag}: the card disagrees with the CPU")
    return mse_c, nfe_c


def _profile_latent(device):
    """Device time by kernel over three latent train steps, and the
    encoder's share of a step (its 49 eager GRU steps, forward and
    autograd)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from localregneuralde_tpu_torch.harness import (
        construct_optimizer, create_train_state, make_train_step,
    )

    cfg, model, (loss_fn, (w_reg, w_kl)), train, _, _ = _latent_setup(device)
    opt, sched = construct_optimizer(cfg)
    ts = create_train_state(model, opt)
    step = make_train_step(model, loss_fn, opt)
    batch = _host_batch(train, device, shuffle=True)
    w = (w_reg(1), w_kl(1))
    ts, _, _ = step(ts, batch, w, sched(1))  # first-call set-up
    # the step, and the encoder alone (its forward and the backward of its
    # output), in turns on the same host
    x = torch.cat(batch, dim=-1)
    enc = [p for n, p in model.named_parameters() if n.startswith("gru.")]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    times = []
    for i in range(10):
        (ts, _, _), t_step = timed(lambda: step(ts, batch, w, sched(i + 2)))
        y, t_fwd = timed(lambda: model.gru(x, model.init_state()["gru"])[0])
        _, t_bwd = timed(lambda: torch.autograd.grad(y.sum(), enc))
        times.append((t_step, t_fwd, t_bwd,
                      100 * (t_fwd + t_bwd) / t_step))
    spread = [(min(t), statistics.median(t), max(t)) for t in zip(*times)]
    (step_ms, fwd_ms, bwd_ms, share) = (
        "{:.3f} / {:.3f} / {:.3f}".format(*s) for s in spread)
    print(f"[profile latent] without the profiler, 10 rounds in turns, min / "
          f"median / max: train step {step_ms} ms; the encoder alone (49 "
          f"eager GRU steps) forward {fwd_ms} ms, backward {bwd_ms} ms; "
          f"encoder share of its round's step {share}%")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3):
            ts, loss, _ = step(ts, batch, w, sched(i + 7))
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / 3
    rows = [(e.key, e.device_time_total / 1e3 / 3, e.count / 3)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"[profile latent] {wall:.3f} ms per train step under the "
          f"profiler, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)")
    for key, ms, cnt in rows[:14]:
        print(f"[profile latent]   {ms:9.3f} ms  x{cnt:6.1f}  {key[:90]}")


def _cifar_setup(device, overrides=(), params=None, regularize="none"):
    """cnn.yaml's model (weights from its seed), loss, optimizer, train
    state and steps, on ``device``."""
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration, make_eval_step,
        make_train_step,
    )

    cfg = define_configuration(
        list(overrides) + [f"--model.regularize={regularize}"], CIFAR_CONFIG)
    model = construct_model(cfg, device=device)
    if params is not None:
        model.load_state_dict(params)
    loss_fn, w_reg = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    return dict(model=model, loss_fn=loss_fn, w_reg=w_reg, sched=sched,
                ts=create_train_state(model, opt),
                train=make_train_step(model, loss_fn, opt),
                eval=make_eval_step(model, loss_fn))


@functools.lru_cache(maxsize=1)
def _cifar_data():
    """The runner's CIFAR-10 arrays (the synthetic stand-in: the real set is
    not in the repository)."""
    from localregneuralde_tpu_torch.harness import (
        define_configuration, get_classification_data,
    )

    return get_classification_data(define_configuration([], CIFAR_CONFIG))


def _cifar_batches(device, split, n, bs=32):
    """``n`` batches of the runner's CIFAR-10 data, normalised as
    ``experiments/cifar10/main.py`` does."""
    import torch

    from localregneuralde_tpu_torch.harness import one_hot
    from localregneuralde_tpu_torch.harness.runner import cifar_normalize

    x_tr, y_tr, x_te, y_te, _ = _cifar_data()
    x, y = (x_tr, y_tr) if split == "train" else (x_te, y_te)
    return [(torch.tensor(cifar_normalize(x[i * bs:(i + 1) * bs]),
                          device=device),
             torch.tensor(one_hot(y[i * bs:(i + 1) * bs], 10), device=device))
            for i in range(n)]


def conv_flops(B_, H_, W_, Cs, Ch):
    """Product FLOPs of one conv-dynamics evaluation: three 3x3 convs."""
    return 2 * B_ * H_ * W_ * 9 * (Cs * Ch + Ch * Ch + Ch * Cs)


def _conv_inputs(device):
    """Kernels 13 and 14's operands at cnn.yaml's full width: the
    dynamics' weights and spec, a state from the model's own augmenter and
    BatchNorm (at FP32), its k1 (FP32), the running stats, t = 0.2 and
    dt = 0.05."""
    import torch

    from localregneuralde_tpu_torch.core import ArrayAndTime
    from localregneuralde_tpu_torch.ops.cuda.fused_conv import running_stats

    s = _cifar_setup(device)
    model = s["model"]
    node = model.neural_ode
    spec, w = node.conv, node.conv_weights()
    x, _ = _cifar_batches(device, "train", 1)[0]
    st0 = model.init_state()
    t = torch.tensor(0.2, device=device)
    dt = torch.tensor(0.05, device=device)
    # the augmenter at FP32 (the CPU's tiers), the digests' input
    with torch.no_grad(), tiers_of("cpu"):
        a, _ = model.augment(x, st0["augment"])
        u, _ = model.bn(a, st0["bn"], training=True)
        u = u.contiguous()
        dyn_st = st0["neural_ode"]["model"]
        k1 = node.model(ArrayAndTime(u, t), dyn_st,
                        training=True)[0].array.contiguous()
        rstats = running_stats(spec, dyn_st)
    return w, spec, u, k1, rstats, t, dt


def phase_conv_kernels(device):
    """Kernels 13 and 14 against their plain versions at cnn.yaml's full
    width, on a state from the model's own augmenter and BatchNorm."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        _build, conv_step_plain, fused_conv_step, fused_conv_step_bwd,
        fused_conv_step_bwd_plain,
    )

    w, spec, u, k1, rstats, t, dt = _conv_inputs(device)
    B_, H_, W_, Cs = u.shape
    Ch = spec.Ch
    res = {}
    step_err = 0.0
    for mode in ("train", "running", "batch"):
        sp = spec._replace(eval_stats="batch") if mode == "batch" else spec
        training = mode == "train"
        with torch.no_grad():
            out = fused_conv_step(w, sp, u, t, dt, k1, training=training,
                                  rstats=rstats)
            ref = conv_step_plain(w, sp, u, t, dt, k1, training=training,
                                  rstats=rstats)
            again = fused_conv_step(w, sp, u, t, dt, k1, training=training,
                                    rstats=rstats)
        # u~ cancels: held to 1e-5 of dt * max |k|
        kscale = float(dt) * max(float(k.abs().max()) for k in ref[2:8])
        ut_err = max_abs(out[1], ref[1]) / kscale
        rel = max(rel_err(out[i], ref[i]) for i in (0, *range(2, 9)))
        stats_rel = (max(rel_err(a_, b_) for a_, b_ in zip(out[9], ref[9]))
                     if training else 0.0)
        bitwise = all(torch.equal(p, q) for p, q in zip(out[:9], again[:9]))
        step_err = max(step_err, max(max_abs(p, q) for p, q in
                                     zip(out[:9], ref[:9])))
        digest({"train": "K13 train", "running": "K13 eval",
                "batch": "K13 eval batch"}[mode], *out[:9],
               *(out[9] if training else ()))
        print(f"[conv step {mode}] vs plain: relative max-abs {rel:.3e} "
              f"(u_new, k2..k7, g6), u~ {ut_err:.3e} of dt*max|k|, running "
              f"stats {stats_rel:.3e}; bitwise deterministic {bitwise}")
        check(rel <= 1e-5 and ut_err <= 1e-5 and stats_rel <= 1e-5
              and bitwise, f"conv step {mode} disagrees with plain")
    # the plain step runs in FP32 (cuDNN TF32 off): against FP64
    with torch.no_grad():
        ref32 = conv_step_plain(w, spec, u, t, dt, k1, training=True,
                                rstats=rstats)
        ref64 = conv_step_plain(
            type(w)(*(p.double() for p in w)), spec, u.double(), t.double(),
            dt.double(), k1.double(), training=True,
            rstats=tuple(r.double() for r in rstats))
    rel64 = rel_err(ref32[0].double(), ref64[0])
    print(f"[conv step] plain step in FP32 vs FP64: u_new relative max-abs "
          f"{rel64:.3e} (TF32 products would give ~1e-3)")
    check(rel64 <= 1e-5, "the plain conv step does not run in FP32")

    g = torch.Generator(device=device).manual_seed(17)
    cts = [torch.randn(u.shape, generator=g, device=device) for _ in range(9)]
    ours = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts)
    ref = fused_conv_step_bwd_plain(w, spec, u, t, dt, k1, cts)
    names = ["d_u", "d_k1", *("d_" + f for f in w._fields)]
    pairs = list(zip([ours[1], ours[2], *ours[0]], [ref[1], ref[2], *ref[0]]))
    rels = {n: rel_err(p, q) for n, (p, q) in zip(names, pairs)}
    digest("K14", ours[1], ours[2], *ours[0])
    again = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts)
    bitwise = all(torch.equal(p, q) for p, q in zip(
        [again[1], again[2], *again[0]], [ours[1], ours[2], *ours[0]]))
    print(f"[conv step_bwd] relative max-abs vs autograd of the plain step "
          f"{ {k: float(f'{v:.3e}') for k, v in rels.items()} }; bitwise "
          f"deterministic {bitwise}")
    check(max(rels.values()) <= 1e-4 and bitwise,
          f"conv step_bwd vs plain: {rels}")
    bwd_err = max(max_abs(p, q) for p, q in pairs)

    # device times: raw launches back to back, one wrapper call, plain
    lib = _build.load_library()
    sc = torch.stack([t, dt])
    outs = [torch.empty_like(u) for _ in range(9)]
    rs = torch.stack(rstats).contiguous()
    rs_out = torch.empty_like(rs)
    scr13 = torch.empty(lib.lrnde_conv_step_scratch_floats(B_, H_, W_, Cs, Ch),
                        device=device)
    raw13 = raw_launch("lrnde_conv_step", u, k1, sc, *w, *outs, rs, rs_out,
                       scr13, 0, spec.momentum, 1.0 - spec.momentum, spec.eps,
                       B_, H_, W_, Cs, Ch)
    grads = [torch.empty_like(p) for p in (u, u, *w)]
    scr14 = torch.empty(
        lib.lrnde_conv_step_bwd_scratch_floats(B_, H_, W_, Cs, Ch),
        device=device)
    raw14 = raw_launch("lrnde_conv_step_bwd", 0, u, k1, sc, *w, *cts,
                       *grads, scr14, spec.eps, B_, H_, W_, Cs, Ch)
    raw13_eval = raw_launch("lrnde_conv_step", u, k1, sc, *w, *outs, rs,
                            None, scr13, 1, spec.momentum,
                            1.0 - spec.momentum, spec.eps, B_, H_, W_, Cs, Ch)
    check(raw13() == 0, "conv kernels: raw launch failed")
    torch.cuda.synchronize()
    phase_conv_stats(lib, scr13, B_, H_, W_, Cs, Ch)
    check(raw14() == 0 and raw13_eval() == 0, "conv kernels: raw launch failed")
    ms13, ms14, ms13_eval = back_to_back_ms([raw13, raw14, raw13_eval], n=20,
                                            warmup=3)
    print(f"[conv attribution] kernel 13 back to back: train {ms13:.4f} ms, "
          f"eval (running stats) {ms13_eval:.4f} ms; kernel 14 {ms14:.4f} ms "
          f"(before the redesign: {PARENT_MS['K13 train']}, "
          f"{PARENT_MS['K13 eval']}, {PARENT_MS['K14']})")
    sequence_split("conv attribution train", raw13, conv_role, ms13)
    sequence_split("conv attribution eval", raw13_eval, conv_role, ms13_eval)
    kernel_split("fused_conv_step", raw13)
    kernel_split("fused_conv_step_bwd", raw14)
    call13, call14 = median_ms(
        [lambda: fused_conv_step(w, spec, u, t, dt, k1, training=True,
                                 rstats=rstats),
         lambda: fused_conv_step_bwd(w, spec, u, t, dt, k1, cts)],
        n=10, warmup=2)
    with torch.no_grad():
        plain13, = median_ms([lambda: conv_step_plain(
            w, spec, u, t, dt, k1, training=True, rstats=rstats)], n=10,
            warmup=2)
    plain14, = median_ms([lambda: fused_conv_step_bwd_plain(
        w, spec, u, t, dt, k1, cts)], n=10, warmup=2)
    n_w = sum(p.numel() for p in w)
    n_u = u.numel()
    f13 = 6 * conv_flops(B_, H_, W_, Cs, Ch)
    # in u, k1 and the weights; out u_new, u~, k2..k7, g6
    res["fused_conv_step"] = dict(
        max_abs_err=step_err, ms=ms13, plain_ms=plain13, call_ms=call13,
        **bound(f13, 4 * (11 * n_u + n_w)))
    # the recompute, the data and the weight gradients: three steps'
    # products; in u, k1, nine cotangents and the weights; out d_u, d_k1
    # and the weight gradients
    res["fused_conv_step_bwd"] = dict(
        max_abs_err=bwd_err, ms=ms14, plain_ms=plain14, call_ms=call14,
        **bound(3 * f13, 4 * (13 * n_u + 2 * n_w)))
    for name in ("fused_conv_step", "fused_conv_step_bwd"):
        r = res[name]
        print(f"[kernel {name}] max-abs {r['max_abs_err']:.3e} | device time "
              f"per call back to back {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms | one wrapper call "
              f"{r.pop('call_ms'):.4f} ms | bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    return res


def phase_conv_stats(lib, scratch, B_, H_, W_, Cs, Ch):
    """Kernel 13's BatchNorm statistics of its last evaluation (training
    mode: z1 and z2 and their batch mean and variance stay in the scratch)
    against float64 two-pass statistics of the same z: the largest |mean
    error| / std and |var error| / var over the channels."""
    import torch

    M = B_ * H_ * W_
    at = lambda which: lib.lrnde_conv_step_offset(  # noqa: E731
        which, B_, H_, W_, Cs, Ch)
    st = scratch[at(2) + 20 * Ch: at(2) + 24 * Ch].double().view(4, Ch)
    errs = []
    for layer in (0, 1):
        z = scratch[at(layer): at(layer) + M * Ch].double().view(M, Ch)
        mean = z.mean(0)
        var = ((z - mean) ** 2).mean(0)
        errs.append((float(((st[2 * layer] - mean).abs() / var.sqrt()).max()),
                     float(((st[2 * layer + 1] - var).abs() / var).max())))
    e_mean = max(e[0] for e in errs)
    e_var = max(e[1] for e in errs)
    print(f"[conv stats fp64] the last evaluation's batch statistics vs "
          f"float64 two-pass statistics of the same z: mean error / std "
          f"{errs[0][0]:.3e} (BN1), {errs[1][0]:.3e} (BN2); var relative "
          f"{errs[0][1]:.3e}, {errs[1][1]:.3e}")
    if K13_STATS_FP64_BEFORE is not None:
        before = K13_STATS_FP64_BEFORE
        print(f"[conv stats fp64] before the redesign: mean {before[0]:.3e}, "
              f"var {before[1]:.3e}")
        check(e_mean <= 2 * before[0] and e_var <= 2 * before[1],
              f"conv stats vs float64: {e_mean:.3e}, {e_var:.3e}, over 2x "
              f"the old kernel's {before}")
    return e_mean, e_var


def _cifar_forward(setup, params, state, data, w_reg):
    """Loss, new layer state, stats and parameter gradients of one training
    forward."""
    import torch

    ps = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss, st_, stats = setup["loss_fn"](setup["model"], ps, state, data, w_reg,
                                        training=True)
    grads = torch.autograd.grad(loss, list(ps.values()), allow_unused=True)
    return loss, st_, stats, dict(zip(ps, grads))


def _bn_leaves(state, prefix=""):
    """The BatchNorm running stats of a layer state, by path."""
    out = {}
    for k, v in state.items():
        if isinstance(v, dict):
            out.update(_bn_leaves(v, f"{prefix}{k}."))
        elif k in ("mean", "var"):
            out[prefix + k] = v
    return out


def phase_cifar(device, profile=False):
    """cnn.yaml through construct_model -> make_eval_step / make_train_step
    as shipped ('auto' at rtol 1e-4: the TF32 tier): three eval
    batches, three train steps per arm, launches per batch and step (and by
    tier); then the first step against the plain path (at the same tiers)
    and four images against the CPU at the card's tiers."""
    import torch

    from localregneuralde_tpu_torch.harness import accuracy, warmup_model
    from localregneuralde_tpu_torch.nn import product_tier
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_mlp_bwd import (
        step_bwd_tiers,
    )

    test = _cifar_batches(device, "test", CIFAR_BATCHES)
    train = _cifar_batches(device, "train", CIFAR_STEPS)
    serve = _cifar_setup(device)
    arms = [(reg, _cifar_setup(device, regularize=reg))
            for reg in ("none", "unbiased")]
    params0 = {k: v.detach().clone() for k, v in serve["ts"].params.items()}
    # first-call set-up (cuDNN plans, the allocator's pools)
    serve["eval"](serve["ts"], test[0], serve["w_reg"](1))
    for _, a in arms:
        warmup_model(a["train"], None, a["ts"], train[0], a["w_reg"](1),
                     a["sched"](1))
    torch.cuda.synchronize()

    def delta(before):
        after = launch_counts()
        return {k: after[k] - before[k] for k in after if after[k] != before[k]}

    # --- the main path: every launch from here to launch_counts() counts
    reset_launch_counts()
    evals, steps = [], []
    for batch in test:
        before, t0 = launch_counts(), time.perf_counter()
        loss, stats = serve["eval"](serve["ts"], batch, serve["w_reg"](1))
        torch.cuda.synchronize()
        evals.append((1e3 * (time.perf_counter() - t0), delta(before), loss,
                      stats, batch))
    for reg, a in arms:
        ts = a["ts"]
        for i, batch in enumerate(train):
            before, t0 = launch_counts(), time.perf_counter()
            ts, loss, stats = a["train"](ts, batch, a["w_reg"](i + 1),
                                         a["sched"](i + 1))
            torch.cuda.synchronize()
            steps.append((reg, i, 1e3 * (time.perf_counter() - t0),
                          delta(before), loss, stats))
        a["ts"] = ts
    counts = launch_counts()

    for i, (ms, c, loss, stats, batch) in enumerate(evals):
        nfe = int(stats["nfe"])
        top1 = float(accuracy(stats["y_pred"], batch[1]))
        print(f"[cifar serve] batch {i}: loss {float(loss):.6f} top-1 "
              f"{top1:.2f}% nfe {nfe} success {bool(stats['solver_success'])} "
              f"{ms:.3f} ms {32 / (ms / 1e3):.1f} images/s | launches {c}")
        # k1 and the dt probe are the plain module; every attempt kernel 13
        check(bool(torch.isfinite(loss)) and bool(stats["solver_success"])
              and tuple(stats["y_pred"].shape) == (32, 10)
              and c == {"fused_conv_step": (nfe - 2) // 6},
              f"cifar serve batch {i}: bad output or launches {c}")
    for reg, i, ms, c, loss, stats in steps:
        nfe = int(stats["nfe"])
        extra = 8 if reg == "unbiased" else 0
        attempts = (nfe - 2 - extra) // 6
        n13 = c.get("fused_conv_step", 0)
        n14 = c.get("fused_conv_step_bwd", 0)
        print(f"[cifar train {reg}] step {i + 1}: loss {float(loss):.6f} "
              f"reg_val {float(stats['reg_val']):.6e} nfe {nfe} success "
              f"{bool(stats['solver_success'])} {ms:.3f} ms "
              f"{nfe / (ms / 1e3):.1f} dynamics evals/s | launches {c} "
              f"({attempts} solve attempts)")
        # kernel 13 once per attempt (+ the regulariser's step), kernel 14
        # once per accepted step (+ the regulariser's step's VJP)
        check(bool(torch.isfinite(loss)) and bool(stats["solver_success"])
              and set(c) <= {"fused_conv_step", "fused_conv_step_bwd"}
              and n13 == attempts + extra // 8
              and 1 + extra // 8 <= n14 <= n13,
              f"cifar train {reg} step {i + 1}: launches {c}")
    tiers = node_tiers(serve["model"], device)
    print(f"[cifar] launch counts { {k: v for k, v in counts.items() if v} }"
          f"; by tier { {k: v for k, v in tier_counts().items() if '[' in k} }"
          f" (the route's forward/gradient tiers {'/'.join(tiers)})")
    counts = tier_counts()

    # --- the first step against the plain path on the card (same t1: both
    # NeuralODEs draw it from a generator seeded with cfg.seed). Each of
    # kernel 13's calls in the solve is held against the plain step on its
    # own inputs, running stats included, each of kernel 14's calls in the
    # sweep against autograd of the plain step on the kernel path's own
    # knots, and the attempts' step sizes of both solves are logged.
    import localregneuralde_tpu_torch.ode.solve as solve_mod
    import localregneuralde_tpu_torch.ops.cuda as ops_cuda
    from localregneuralde_tpu_torch.ops.cuda import (
        conv_step_plain, fused_conv_step_bwd_plain,
    )

    k13, k14 = ops_cuda.fused_conv_step, ops_cuda.fused_conv_step_bwd
    attempt = solve_mod.attempt
    ema_errs, vjp_errs = [], []

    def held(w, spec, u, t, dt, k1, *, training, rstats=None,
             precision="highest"):
        """Kernel 13's EMA chain against the plain step's at its tier: FP32
        within 1e-5; at TF32 (the statistics of one evaluation's convs)
        within one evaluation's TF32 rounding."""
        out = k13(w, spec, u, t, dt, k1, training=training, rstats=rstats,
                  precision=precision)
        if training:
            tier = product_tier(precision, u.device)
            ref = conv_step_plain(w, spec, u, t, dt, k1, training=True,
                                  rstats=rstats, tier=tier)
            ema_errs.append((
                max(max_abs(p, q) for p, q in zip(out[9], ref[9]))
                / max(float(r.abs().max()) for r in ref[9]),
                1e-5 if tier == "fp32" else tf32_tol(CONV_EVAL_PRODUCTS)))
        return out

    def held_vjp(w, spec, u, t, dt, k1, cts, precision="highest",
                 grad_precision="match"):
        """Kernel 14 and the plain VJP at its tiers, each against the FP64
        one (on these cotangents d_k1 is a cancelling sum of the stages'
        a_ej terms, so both carry more error there than on random ones):
        the kernel within 1e-4 (with TF32 products, the tensor cores'
        truncated sums through a transposed step, ``tf32_sum_tol``) or
        twice the plain VJP's own error."""
        d_w, d_u, d_k1 = k14(w, spec, u, t, dt, k1, cts, precision,
                             grad_precision)
        tiers = step_bwd_tiers(precision, grad_precision, u.device)
        r_w, r_u, r_k1 = fused_conv_step_bwd_plain(w, spec, u, t, dt, k1,
                                                   cts, *tiers)
        x_w, x_u, x_k1 = fused_conv_step_bwd_plain(
            type(w)(*(p.double() for p in w)), spec, u.double(),
            torch.as_tensor(t).double(), torch.as_tensor(dt).double(),
            k1.double(), [c.double() for c in cts])
        floor = (1e-4 if tiers == ("fp32", "fp32") else tf32_sum_tol(
            CONV_STEP_BWD_PRODUCTS, 9 * (spec.Ch + 1)))
        names = ["d_u", "d_k1", *("d_" + f for f in w._fields)]
        vjp_errs.append({
            n: (rel_err(p.double(), x), max(floor, 2 * rel_err(q.double(),
                                                               x)))
            for n, p, q, x in zip(names, (d_u, d_k1, *d_w),
                                  (r_u, r_k1, *r_w), (x_u, x_k1, *x_w))})
        return d_w, d_u, d_k1

    def logged(log):
        def fn(*args, **kw):
            a = attempt(*args, **kw)
            log.append(float(a.dt_c))
            return a
        return fn

    for reg, a in arms:
        sd = serve["model"].state_dict()
        plain = _cifar_setup(device, ["--model.use_pallas=off"], sd, reg)
        data = train[0]
        dts_o, dts_r = [], []
        try:
            ops_cuda.fused_conv_step = held
            ops_cuda.fused_conv_step_bwd = held_vjp
            solve_mod.attempt = logged(dts_o)
            _, st_o, s_o, g_o = _cifar_forward(a, params0,
                                               a["model"].init_state(), data,
                                               0.0)
            solve_mod.attempt = logged(dts_r)
            _, st_r, s_r, g_r = _cifar_forward(
                plain, params0, plain["model"].init_state(), data, 0.0)
        finally:
            ops_cuda.fused_conv_step, ops_cuda.fused_conv_step_bwd = k13, k14
            solve_mod.attempt = attempt
        n_o, n_r = int(s_o["nfe"]), int(s_r["nfe"])
        ce_o = float(s_o["ce_loss"].detach())
        ce_r = float(s_r["ce_loss"].detach())
        ce_gate = max(1e-4 * max(1.0, abs(ce_r)), cross_entropy_tol(
            tiers, tiers, s_r["y_pred"], **CONV_DEPTHS))
        head = (f"[cifar train {reg}] first step vs the card's plain path "
                f"(both at {'/'.join(tiers)}): "
                f"NFE {n_o} vs {n_r}, cross-entropy {ce_o:.6f} vs {ce_r:.6f} "
                f"(tolerance {ce_gate:.3e}), "
                f"reg_val {float(s_o['reg_val'].detach()):.6e} vs "
                f"{float(s_r['reg_val'].detach()):.6e}; kernel 13's running "
                f"stats vs the plain EMA chain on the same inputs, "
                f"{len(ema_errs)} calls, relative max-abs "
                f"{max(e for e, _ in ema_errs):.3e} (tolerance "
                f"{ema_errs[0][1]:.3e}); kernel 14 against the FP64 VJP on "
                f"the kernel path's knots, {len(vjp_errs)} calls, relative "
                f"max-abs and its gate (twice the plain VJP's at its tiers, "
                f"at least 1e-4, or at TF32 the truncated sums) "
                f"{ {n: tuple(float(f'{max(e[n][i] for e in vjp_errs):.3e}') for i in (0, 1)) for n in vjp_errs[0]} }")
        print(head)
        check(abs(ce_o - ce_r) <= ce_gate
              and all(e <= g for e, g in ema_errs)
              and all(ek <= gate for e in vjp_errs
                      for ek, gate in e.values()),
              f"cifar {reg}: cross-entropy, running stats or kernel 14 "
              f"disagree with the plain path; kernel 14 per call: {vjp_errs}")
        ema_errs.clear()
        vjp_errs.clear()
        if n_o != n_r:
            print(f"[cifar train {reg}] the step sequences differ (f32 noise "
                  f"in the error estimate), so the whole step's gradients "
                  f"are not compared")
            continue
        # the attempts' step sizes: the error estimate at rtol 1e-4 carries
        # f32 noise, so the controller's proposals differ slightly, and the
        # last step (clipped to the span) by the most
        dt_rel = max(abs(p - q) / q for p, q in zip(dts_o, dts_r))
        # relative to the largest gradient and running stat: some are zero
        # (the augmenter's bias: the BatchNorm after it removes it) or near
        # it (running means)
        rel = (max(max_abs(g_o[k], g_r[k]) for k in g_o)
               / max(float(g.abs().max()) for g in g_r.values()))
        bn_o, bn_r = _bn_leaves(st_o), _bn_leaves(st_r)
        rel_bn = (max(max_abs(bn_o[k], bn_r[k]) for k in bn_r)
                  / max(float(v.abs().max()) for v in bn_r.values()))
        g_tol = grads_tol(tiers, node_tiers(plain["model"], device),
                          **CONV_DEPTHS)
        print(f"[cifar train {reg}] first step: step sizes relative max-abs "
              f"{dt_rel:.3e}; gradients "
              f"of the cross-entropy relative max-abs {rel:.3e} (tolerance "
              f"{g_tol:.3e}); BatchNorm "
              f"running stats after the step {rel_bn:.3e} (the statistics "
              f"are taken at the stages, so they follow the step sizes)")
        check(rel <= g_tol and (rel_bn <= 1e-4 or dt_rel > 1e-5),
              f"cifar {reg}: gradients or state disagree with the plain path")
    # 4 test images: the card's kernel path against the CPU at the card's
    # tiers
    cpu = _cifar_setup("cpu", [], {k: v.cpu() for k, v in
                                   serve["model"].state_dict().items()})
    small = (test[0][0][:4], test[0][1][:4])
    _, on_card = serve["eval"](serve["ts"], small, serve["w_reg"](1))
    with tiers_of(device):
        _, on_cpu = cpu["eval"](cpu["ts"], tuple(d.cpu() for d in small),
                                cpu["w_reg"](1))
    err = rel_err(on_card["y_pred"].cpu(), on_cpu["y_pred"])
    tol, _ = logits_tol(tiers, node_tiers(cpu["model"], device),
                        **CONV_DEPTHS)
    print(f"[cifar serve] 4 images, card kernels vs CPU plain at the card's "
          f"tiers ({'/'.join(tiers)}): logits relative max-abs {err:.3e} "
          f"(tolerance {tol:.3e}), nfe {int(on_card['nfe'])} vs "
          f"{int(on_cpu['nfe'])}")
    check(err <= tol, "cifar serve: the card disagrees with the CPU")
    if profile:
        _profile_cifar(arms, train)
    return counts


def _profile_cifar(arms, batches):
    """Device time by kernel over two train steps per arm: inside the ODE
    the conv kernels run; cuDNN serves the augmenter, the classifier, k1,
    the dt probes and the FSAL closure."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for reg, a in arms:
        ts = a["ts"]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(2):
                ts, _, _ = a["train"](ts, batches[i], a["w_reg"](1),
                                      a["sched"](1))
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 2
        a["ts"] = ts
        rows = [(e.key, e.device_time_total / 1e3 / 2, e.count / 2)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        ours = sum(r[1] for r in rows if "lrnde" in r[0])
        print(f"[profile cifar {reg}] {wall:.3f} ms per train step under the "
              f"profiler, device busy {busy:.3f} ms ({100 * busy / wall:.1f}%)"
              f", of which the port's kernels {ours:.3f} ms")
        for key, ms, cnt in rows[:16]:
            print(f"[profile cifar {reg}]   {ms:9.3f} ms  x{cnt:7.1f}  "
                  f"{key[:90]}")


SCORE_B, SCORE_F = 4096, 2   # scripts/vpsde_ab.py:37-48, the demo's width
SCORE_TOL = 1e-2             # rtol = atol of the SDE sampler
SCORE_MAX_STEPS = 4096
SCORE_DRAWS = 3              # draws per sampler


def _score_net(device, features=SCORE_F, seed=0):
    """The score demo's network (scripts/score_sde_demo.py:66), TDChain(
    Dense(3, 64, tanh), Dense(65, 64, tanh), Dense(65, 2)), with the
    Dense layers' own Glorot init from ``seed``."""
    import torch

    from localregneuralde_tpu_torch.models import TDChain
    from localregneuralde_tpu_torch.nn import Dense

    g = torch.Generator().manual_seed(seed)
    return TDChain(Dense(features + 1, 64, "tanh", generator=g, device=device),
                   Dense(65, 64, "tanh", generator=g, device=device),
                   Dense(65, features, generator=g, device=device))


def _neg_identity_net(device, features):
    """TDChain(Dense(F + 1, F)) with s(x, t) = −x, the exact score of
    N(0, I) data (examples/sampling.py:46-56)."""
    import torch

    from localregneuralde_tpu_torch.models import TDChain
    from localregneuralde_tpu_torch.nn import Dense

    net = TDChain(Dense(features + 1, features, device=device))
    with torch.no_grad():
        net.layers["layer_0"].w.zero_()
        net.layers["layer_0"].w[:features] = -torch.eye(features)
    return net


def score_flops(dims, b):
    """Product FLOPs of one score-chain evaluation of b rows."""
    return 2 * b * sum((dims[i] + 1) * dims[i + 1]
                       for i in range(len(dims) - 1))


def _vpsde_raw_args(ps, chain, u0, span, saveat, sched, noise,
                    tier="fp32"):
    """Kernel 11's C operands (SOSRI at SCORE_TOL) with the wrapper's first
    drift evaluation and dt heuristic (at ``tier``) run here, once. Returns
    the argument list (without the stream), the grid barrier and the
    y_final buffer."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import _build
    from localregneuralde_tpu_torch.ops.cuda import fused_sde_solve as fs

    B, F = u0.shape
    t0, te = span
    n_blocks = -(-B // _build.load_library().lrnde_score_rows_per_block())
    new = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=u0.device)
    drift, _ = fs.vpsde_dynamics(ps, chain, **sched, tier=tier)
    dt = fs.initial_dt(u0, drift(u0, t0), SCORE_TOL, SCORE_TOL, t0, te)
    bar = torch.zeros(1, dtype=torch.int32, device=u0.device)
    y = new(B, F)
    wz = new(2, 2, B, F)
    args = [1, u0, fs.device_scalars([t0, te, dt], u0), saveat, 1,
            *fs.score_operands(ps, chain, **sched),
            noise.seed_word(u0.device), 24, y,
            new(1, B, F), new(4, dtype=torch.int32), new(2), new(B, F), wz[0],
            wz[1], new(2 * n_blocks), bar, B, SCORE_MAX_STEPS, SCORE_TOL,
            SCORE_TOL, 1 / 6, 1.0 / (B * F)]
    return args, bar, y


def _score_raw(ps, chain, u0, span, saveat, sched, noise):
    """Raw launches of kernels 11 (SOSRI at SCORE_TOL) and 6 (rtol 1e-4,
    atol 1e-6) with the wrappers' operands built once: the first
    evaluations and the dt heuristics run here, not in the timed call. Each
    launch zeroes its grid barrier first (one memset). Returns the two
    launchers and their y_final buffers."""
    args11, bar11, y11 = _vpsde_raw_args(ps, chain, u0, span, saveat, sched,
                                         noise)
    k11 = raw_launch("lrnde_vpsde_solve", *args11)
    args6, bar6, y6 = _pf_raw_args(ps, chain, u0, span, saveat, sched)
    k6 = raw_launch("lrnde_persistent_pf", *args6)
    return ((lambda: (bar11.zero_(), k11())[1]),
            (lambda: (bar6.zero_(), k6())[1])), (y11, y6)


def _pf_raw_args(ps, chain, u0, span, saveat, sched, tier="fp32"):
    """Kernel 6's C operands (rtol 1e-4, atol 1e-6) as persistent_pf_solve
    passes them, k1 and the dt heuristic (at ``tier``) run here, once;
    without the stream. Returns the arguments, the grid barrier and
    y_final."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import fused_sde_solve as fs
    from localregneuralde_tpu_torch.ops.cuda import fused_solve as fo

    B, F = u0.shape
    t0, te = span
    new = lambda *shape, dtype=torch.float32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=u0.device)
    k1, dt, _ = fo._start(fo.pf_dynamics(ps, chain, **sched, tier=tier), u0,
                          t0, te, 1e-4, 1e-6)
    bar = torch.zeros(1, dtype=torch.int32, device=u0.device)
    y = new(B, F)
    n_blocks = -(-B // PF_ERROR_ROWS)
    args = [u0, k1, fs.device_scalars([t0, te, dt], u0), saveat,
            saveat.shape[0], *fs.score_operands(ps, chain, **sched), y,
            new(saveat.shape[0], B, F), new(4, dtype=torch.int32), new(2),
            new(2 * n_blocks), bar, B, SCORE_MAX_STEPS, 1e-4, 1e-6,
            1.0 / (B * F)]
    return args, bar, y


# lrnde_pf_solve_probe's layouts of kernel 6, in order
PF_PROBES = ("the kernel's: 4 rows a warp, 64 -> 64 weights in registers, "
             "the last layer's accumulators on 4 lanes",
             "4 rows a warp, 64 -> 64 weights in registers",
             "4 rows a warp, a lane an output",
             "8 rows a warp, a lane an output",
             "2 rows a warp, a lane an output")


def phase_pf_probe(ps, chain, u0, span, saveat, sched, ref):
    """Kernel 6 in each layout of lrnde_pf_solve_probe at the score demo's
    draw: bitwise the kernel's result, then device ms per raw launch back
    to back, in turns."""
    import torch

    args, bar, y = _pf_raw_args(ps, chain, u0, span, saveat, sched)
    fns = []
    for v, name in enumerate(PF_PROBES):
        fn = raw_launch("lrnde_pf_solve_probe", v, *args)
        y.zero_()
        check((bar.zero_(), fn())[1] == 0 and torch.equal(y, ref["y_final"]),
              f"pf probe {name}: the result differs from the kernel's")
        fns.append(lambda fn=fn: (bar.zero_(), fn())[1])
    ms = back_to_back_ms(fns, n=10, warmup=1)
    print("[pf probe] device ms per raw launch back to back, bitwise the "
          "kernel: " + ", ".join(f"{n} {m:.4f}" for n, m in zip(PF_PROBES,
                                                                 ms)))
    return ms


def phase_pf_solve_attribution(ps, chain, u0, span, saveat, sched, ref,
                               runs=3):
    """Kernel 6's attempt by phase at the score demo's draw: the clocked
    instantiation (lrnde_persistent_pf_timed, launched only here), CTA 0's
    %globaltimer summed over the attempts in the library's phases, bitwise
    the untimed kernel and of its attempt count."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    names = _phase_names(lib, "lrnde_pf_solve_phase_names")
    args, bar, y = _pf_raw_args(ps, chain, u0, span, saveat, sched)

    def timed(tm):
        bar.zero_()
        return raw_launch("lrnde_persistent_pf_timed", *args, tm)()

    err, per, natt, spread = _clocked(timed, len(names), u0.device, runs)
    check(err == 0, "pf solve attribution: launch failed")
    check(torch.equal(y, ref["y_final"]),
          "pf solve attribution: the timed kernel's result differs")
    check(natt == (int(ref["nfe"]) - 2) // 6,
          "pf solve attribution: attempt count")
    split = {k: round(v, 3) for k, v in zip(names, per)}
    print(f"[pf solve attribution] {natt} attempts, CTA 0, µs per attempt "
          f"(mean of {runs} launches): {split}; sum {sum(per):.3f}"
          + (f"; at most {spread[0]} CTA(s) an SM, {spread[1]} SMs"
             if spread else "") + "; bitwise the untimed kernel")
    return split


# sde_solve.cu::SdePhase, in order (the descent's walk to τ, its draws and
# their combination with the increments)
SDE_PHASES = ("walk", "draws", "combine", "stage 1", "stage 2", "stage 3",
              "stage 4", "slot store", "barrier wait", "slot sum", "commit",
              "plan")


def phase_vpsde_attribution(device, runs=3):
    """Kernel 11's time per attempt by phase: the instantiation with the
    compile-time clock (lrnde_vpsde_solve_timed, launched only here) on the
    score demo's draw of phase_score_kernels, CTA 0's %globaltimer summed
    over the attempts. Its result must be bitwise the untimed kernel's."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        _build, match_td_score_chain, persistent_vpsde_solve,
        score_chain_params,
    )
    from localregneuralde_tpu_torch.sde import PhiloxNormals

    lib = _build.load_library()
    check(lib.lrnde_sde_phases() == len(SDE_PHASES),
          "the kernel's phases are not SDE_PHASES")
    net = _score_net(device)
    chain = match_td_score_chain(net)
    ps = [p.detach() for p in score_chain_params(net, chain)]
    u0 = torch.randn((SCORE_B, SCORE_F),
                     generator=torch.Generator().manual_seed(0)).to(device)
    span = (0.0, 1.0 - 1e-3)
    saveat = torch.tensor([span[1]], device=device)
    sched = dict(beta_min=0.1, beta_max=20.0, t1=1.0)
    noise = PhiloxNormals(1234, SCORE_B, SCORE_F, device=device)
    ref = persistent_vpsde_solve(
        ps, chain, u0, span, noise=noise, rtol=SCORE_TOL, atol=SCORE_TOL,
        solver="sosri", delta=1 / 6, saveat_arr=saveat,
        max_steps=SCORE_MAX_STEPS, **sched)
    args, bar, y = _vpsde_raw_args(ps, chain, u0, span, saveat, sched, noise)
    timing = torch.zeros(len(SDE_PHASES) + 1, dtype=torch.int64, device=device)
    timed = raw_launch("lrnde_vpsde_solve_timed", *args, timing)
    totals = torch.zeros(len(SDE_PHASES) + 1, dtype=torch.float64)
    for i in range(runs + 1):
        bar.zero_()
        check(timed() == 0, "vpsde attribution: launch failed")
        torch.cuda.synchronize()
        if i > 0:  # the first launch warms up
            totals += timing.cpu().double()
    check(torch.equal(y, ref["y_final"]),
          "vpsde attribution: the timed kernel's result differs")
    natt = int(timing[-1])
    check(natt == int(ref["natt"]), "vpsde attribution: attempt count differs")
    per = (totals[:-1] / totals[-1] / 1e3).tolist()
    split = {name: round(us, 3) for name, us in zip(SDE_PHASES, per)}
    print(f"[vpsde attribution] {natt} attempts, CTA 0, µs per attempt "
          f"(mean of {runs} launches): {split}; sum {sum(per):.3f}")
    return split


def phase_conv_core(device):
    """The conv GEMM core of kernels 13 and 14 alone, one orientation at a
    time at the CIFAR shapes (B = 32, 32x32): forward, data gradient and
    weight gradient at N = 64 and N = 8, against cuDNN in FP32 on the same
    conv (timed as the yardstick, never called by the port). Returns one
    entry per orientation."""
    import torch
    from torch.nn.grad import conv2d_input, conv2d_weight

    from localregneuralde_tpu_torch.ops.cuda import _build

    lib = _build.load_library()
    b, h, w = 32, 32, 32
    M = b * h * w
    g = torch.Generator().manual_seed(3)
    rows = []
    # (name, orient, cin, cout): the K14 GEMMs at cnn.yaml's width (Ch 64,
    # Cs 8): conv2 and conv3 forward, conv2 and conv1 data gradients, conv2
    # and conv3 weight gradients
    cases = (("forward N=64", 0, 64, 64),
             ("forward N=64 + BN statistics", 5, 64, 64),
             ("forward N=8", 0, 64, 8),
             ("data grad N=64", 1, 64, 64), ("data grad N=8", 1, 64, 8),
             ("weight grad N=64", 2, 64, 64), ("weight grad N=8", 2, 64, 8))
    sc = torch.tensor([0.37, 0.0], device=device)
    for name, orient, cin, cout in cases:
        x = torch.randn(b, h, w, cin, generator=g).to(device)
        nchw = lambda t: t.permute(0, 3, 1, 2)  # noqa: E731
        if orient in (0, 5):
            wt = (0.05 * torch.randn(3, 3, cin, cout, generator=g)).to(device)
            w_l = wt.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            lib_fn = lambda: torch.nn.functional.conv2d(  # noqa: E731
                nchw(x), w_l, padding=1)
            out = torch.empty(b, h, w, cout, device=device)
            ref = lib_fn().permute(0, 2, 3, 1)
            flops = 2 * M * 9 * cin * cout
            ops = (x, wt)
        elif orient == 1:
            # the layer maps cout (+ time) channels to cin; x is its output
            # cotangent
            wt = (0.05 * torch.randn(3, 3, cout + 1, cin, generator=g)).to(
                device)
            w_l = wt[:, :, :cout].permute(3, 0, 1, 2).contiguous().permute(
                0, 3, 1, 2)
            lib_fn = lambda: conv2d_input(  # noqa: E731
                (b, cout, h, w), w_l, nchw(x), padding=1)
            out = torch.empty(b, h, w, cout, device=device)
            ref = lib_fn().permute(0, 2, 3, 1)
            flops = 2 * M * 9 * cin * cout
            ops = (x, wt)
        else:
            dy = torch.randn(b, h, w, cout, generator=g).to(device)
            x1 = torch.cat([x, torch.full((b, h, w, 1), float(sc[0]),
                                          device=device)], dim=-1)
            lib_fn = lambda: conv2d_weight(  # noqa: E731
                nchw(x1), (cout, cin + 1, 3, 3), nchw(dy), padding=1)
            out = torch.empty(3, 3, cin + 1, cout, device=device)
            ref = lib_fn().permute(2, 3, 1, 0)
            flops = 2 * M * 9 * (cin + 1) * cout
            ops = (x, dy)
        scratch = torch.empty(
            lib.lrnde_conv_core_scratch_floats(orient, b, h, w, cin, cout),
            device=device)
        raw = raw_launch("lrnde_conv_core", orient, 0, *ops, sc, out, scratch,
                         b, h, w, cin, cout)
        check(raw() == 0, f"conv core {name}: launch failed")
        scale = float(ref.abs().max())
        err = max_abs(out, ref)
        check(err <= 1e-4 * scale, f"conv core {name} vs cuDNN FP32: {err} "
              f"of {scale}")
        again = out.clone()
        check(raw() == 0 and torch.equal(out, again),
              f"conv core {name} is not bitwise repeatable")
        if orient == 5:  # the epilogue's statistics against float64
            z = out.reshape(-1, cout).double()
            mean, var = z.mean(0), z.var(0, unbiased=False)
            st = scratch[:2 * cout].double()
            s_err = max(float(((st[:cout] - mean).abs() / var.sqrt()).max()),
                        float(((st[cout:] - var).abs() / var).max()))
            print(f"[conv core] {name}: statistics vs float64 {s_err:.2e}")
            check(s_err <= 1e-5, f"conv core {name}: statistics {s_err}")
            # the statistics' cost by level: tile moments, the groups' fold,
            # the final fold
            cuts = [raw_launch("lrnde_conv_core", o, 0, *ops, sc, out, scratch, b,
                               h, w, cin, cout) for o in (6, 7)]
            check(all(c() == 0 for c in cuts), f"conv core {name}: probe")
            plain = raw_launch("lrnde_conv_core", 0, 0, *ops, sc,
                               torch.empty_like(out), scratch, b, h, w, cin,
                               cout)
            t_full, t_groups, t_tiles, t_plain = back_to_back_ms(
                [raw] + cuts + [plain], n=50, warmup=5)
            print(f"[conv core] {name} by level: plain {1e3 * t_plain:.2f} µs, "
                  f"+ tile moments {1e3 * t_tiles:.2f}, + group folds "
                  f"{1e3 * t_groups:.2f}, + final fold {1e3 * t_full:.2f}")
        fns = [raw, lib_fn]
        if cout <= 8 and orient < 2:
            # the thin convs run on the halo tile: bitwise the gather tile
            out_g = torch.empty_like(out)
            fns.append(raw_launch("lrnde_conv_core", orient + 3, 0, *ops, sc,
                                  out_g, scratch, b, h, w, cin, cout))
            check(fns[-1]() == 0 and torch.equal(out, out_g),
                  f"conv core {name}: the halo tile differs from the gather "
                  f"tile")
        with torch.no_grad():
            ms, lib_ms, *gather = back_to_back_ms(fns, n=50, warmup=5)
        if gather:
            print(f"[conv core] {name}: halo tile {1e3 * ms:.2f} µs, bitwise "
                  f"the gather tile's outputs, which take "
                  f"{1e3 * gather[0]:.2f} µs")
        nbytes = 4 * (sum(t.numel() for t in ops) + out.numel())
        row = dict(name=name, cin=cin, cout=cout, ms=ms,
                   tflops=flops / ms / 1e9, library_ms=lib_ms,
                   library_tflops=flops / lib_ms / 1e9,
                   max_abs_err=err, **{k: v for k, v in bound(
                       flops, nbytes).items() if k != "library_ms"})
        print(f"[conv core] {name} (Cin {cin}, Cout {cout}): "
              f"{1e3 * ms:.2f} µs, {row['tflops']:.2f} TFLOP/s | cuDNN FP32 "
              f"{1e3 * lib_ms:.2f} µs, {row['library_tflops']:.2f} TFLOP/s | "
              f"bound {1e3 * row['bound_ms']:.2f} µs | max-abs {err:.2e} of "
              f"{scale:.2e}, bitwise repeatable")
        rows.append(row)
    print(json.dumps({"conv_core": rows}))
    return rows


def phase_score_kernels(device):
    """Kernels 11 and 6 against their plain versions at the score demo's
    width (B = 4096, F = 2, random weights from seed 0), bitwise
    repeatability, and the analytic N(0, I) checks."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        match_td_score_chain, persistent_pf_solve, persistent_pf_solve_plain,
        persistent_vpsde_solve, persistent_vpsde_solve_plain,
        score_chain_params,
    )
    from localregneuralde_tpu_torch.sde import PhiloxNormals

    net = _score_net(device)
    chain = match_td_score_chain(net)
    check(chain is not None, "the score demo's network is not the kernels'")
    ps = [p.detach() for p in score_chain_params(net, chain)]
    u0 = torch.randn((SCORE_B, SCORE_F),
                     generator=torch.Generator().manual_seed(0)).to(device)
    span = (0.0, 1.0 - 1e-3)
    saveat = torch.tensor([span[1]], device=device)
    sched = dict(beta_min=0.1, beta_max=20.0, t1=1.0)
    n_params = sum(p.numel() for p in ps)
    res = {}

    # kernel 11 — the same Philox seed, so the same Brownian path
    kw = dict(noise=PhiloxNormals(1234, SCORE_B, SCORE_F, device=device),
              rtol=SCORE_TOL, atol=SCORE_TOL, solver="sosri", delta=1 / 6,
              saveat_arr=saveat, max_steps=SCORE_MAX_STEPS, **sched)
    out = persistent_vpsde_solve(ps, chain, u0, span, **kw)
    digest("K11", out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = persistent_vpsde_solve_plain(ps, chain, u0, span, **kw)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    na, nb = int(out["naccept"]), int(ref["naccept"])
    ra, rb = int(out["nreject"]), int(ref["nreject"])
    scale = float(ref["y_final"].abs().max())
    err = max_abs(out["y_final"], ref["y_final"])
    print(f"[vpsde solve] kernel {na} accepts {ra} rejects, loop {nb} / {rb}; "
          f"y_final max-abs {err:.3e} of max|y| {scale:.3e} "
          f"({err / scale:.2e}); loop {plain:.1f} ms")
    check(bool(out["success"]) and bool(ref["success"]),
          "vpsde solve: not successful")
    check(na == nb and ra == rb, f"vpsde solve: steps {na}/{ra} vs {nb}/{rb}")
    # K10's Hölder-1/2 band (tests/test_torch_sde.py), relative: the
    # reverse drift ½β·u amplifies the path's ulp-level shifts with u
    check(err <= 1e-3 * scale and bool(torch.isfinite(out["y_final"]).all()),
          f"vpsde solve vs plain: {err} of {scale}")
    again = persistent_vpsde_solve(ps, chain, u0, span, **kw)
    check(torch.equal(again["y_final"], out["y_final"])
          and int(again["natt"]) == int(out["natt"]),
          "vpsde solve is not bitwise repeatable")
    (raw11, raw6), raw_y = _score_raw(ps, chain, u0, span, saveat, sched,
                                      kw["noise"])
    check(raw11() == 0 and torch.equal(raw_y[0], out["y_final"]),
          "vpsde solve: the raw launch differs from the wrapper's")
    ms, wrapped = back_to_back_ms(
        [raw11, lambda: persistent_vpsde_solve(ps, chain, u0, span, **kw)],
        n=5, warmup=1)
    natt = na + ra
    print(f"[vpsde solve] bitwise repeatable; kernel {ms:.3f} ms per raw "
          f"launch back to back ({1e3 * ms / natt:.2f} µs per attempt), "
          f"{wrapped:.3f} ms per wrapper call")
    # four drift evaluations an attempt; in u0 and the network, out y_final
    # and ys. The products alone, and with the Brownian tree's draws:
    # (depth + 1) a (column pair, row) an attempt
    nbytes = 4 * (3 * SCORE_B * SCORE_F + n_params)
    flops = 4 * natt * score_flops(chain.dims, SCORE_B)
    products = bound(flops, nbytes)
    tree = tree_bound(natt * 25 * SCORE_B * (-(-SCORE_F // 2)), flops,
                      nbytes)
    print(f"[vpsde solve] bound: products only {products['bound_ms']:.5f} ms "
          f"(share {100 * products['bound_ms'] / ms:.2f}%), with the tree's "
          f"draws {tree['bound_ms']:.5f} ms (share "
          f"{100 * tree['bound_ms'] / ms:.2f}%; the kernels line's)")
    res["persistent_vpsde_solve"] = dict(max_abs_err=err, ms=ms,
                                         plain_ms=plain, **tree)

    # kernel 6 — the same ODE: within one accept, 5e-5 of max|y|
    pkw = dict(rtol=1e-4, atol=1e-6, saveat_arr=saveat,
               max_steps=SCORE_MAX_STEPS, **sched)
    out = persistent_pf_solve(ps, chain, u0, span, **pkw)
    digest("K6", out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = persistent_pf_solve_plain(ps, chain, u0, span, **pkw)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    na, nb = int(out["naccept"]), int(ref["naccept"])
    scale = float(ref["y_final"].abs().max())
    err = max_abs(out["y_final"], ref["y_final"])
    print(f"[pf solve] kernel {na} accepts nfe {int(out['nfe'])}, loop {nb} "
          f"nfe {int(ref['nfe'])}; y_final max-abs {err:.3e} of max|y| "
          f"{scale:.3e}; loop {plain:.1f} ms")
    check(bool(out["success"]) and bool(ref["success"]) and abs(na - nb) <= 1
          and err <= 5e-5 * scale, "pf solve disagrees with the loop")
    again = persistent_pf_solve(ps, chain, u0, span, **pkw)
    check(torch.equal(again["y_final"], out["y_final"])
          and int(again["nfe"]) == int(out["nfe"]),
          "pf solve is not bitwise repeatable")
    check(raw6() == 0 and torch.equal(raw_y[1], out["y_final"]),
          "pf solve: the raw launch differs from the wrapper's")
    phase_pf_solve_attribution(ps, chain, u0, span, saveat, sched, out)
    phase_pf_probe(ps, chain, u0, span, saveat, sched, out)
    ms, wrapped = back_to_back_ms(
        [raw6, lambda: persistent_pf_solve(ps, chain, u0, span, **pkw)],
        n=10, warmup=1)
    natt = (int(out["nfe"]) - 2) // 6
    print(f"[pf solve] bitwise repeatable; kernel {ms:.4f} ms per raw launch "
          f"back to back ({1e3 * ms / natt:.2f} µs per attempt; before the "
          f"redesign {PARENT_MS.get('K6')}), {wrapped:.3f} ms per wrapper "
          f"call")
    # six evaluations an attempt; in u0, k1 and the network, out y_final, ys
    res["persistent_pf_solve"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound(6 * natt * score_flops(chain.dims, SCORE_B),
                4 * (4 * SCORE_B * SCORE_F + n_params)))

    # the analytic case: s = −x keeps N(0, I), so the reverse SDE recovers
    # it and the probability flow does not move
    F8 = 8
    net8 = _neg_identity_net(device, F8)
    c8 = match_td_score_chain(net8)
    p8 = [p.detach() for p in score_chain_params(net8, c8)]
    x8 = torch.randn((SCORE_B, F8),
                     generator=torch.Generator().manual_seed(1)).to(device)
    s = persistent_vpsde_solve(
        p8, c8, x8, span, noise=PhiloxNormals(9, SCORE_B, F8, device=device),
        rtol=SCORE_TOL, atol=SCORE_TOL, solver="sri", delta=1 / 6,
        saveat_arr=saveat, max_steps=SCORE_MAX_STEPS, **sched)
    y = persistent_pf_solve(p8, c8, x8, span, rtol=1e-4, atol=1e-6,
                            saveat_arr=saveat, max_steps=SCORE_MAX_STEPS,
                            **sched)
    mean, std = float(s["y_final"].mean()), float(s["y_final"].std())
    moved = max_abs(y["y_final"], x8)
    print(f"[score analytic] s = -x, B = {SCORE_B}, F = {F8}: SDE samples "
          f"mean {mean:+.4f} std {std:.4f} ({int(s['naccept'])} accepts); "
          f"probability flow moved u_init by {moved:.2e}")
    check(bool(s["success"]) and bool(y["success"]) and abs(mean) < 0.05
          and abs(std - 1) < 0.05 and moved <= 1e-4,
          "the analytic N(0, I) checks failed")
    for name in ("persistent_vpsde_solve", "persistent_pf_solve"):
        r = res[name]
        print(f"[kernel {name}] max-abs {r['max_abs_err']:.3e} | device time "
              f"per call back to back {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms | bound {r['bound_ms']:.5f} ms "
              f"({r['bound_by']})")
    return res


def phase_score_sampling(device):
    """The score samplers through their entry points at the demo config, at
    the reference's tiers (the backend default: kernels 11 and 6 at TF32 on
    the card): three draws each of sample_vpsde and sample_probability_flow
    with ms, samples/s, NFE and launches by tier; then a B = 256 draw
    against the CPU at the card's tiers. Returns the launch counts with
    tiers."""
    import torch

    from localregneuralde_tpu_torch.models import (
        sample_probability_flow, sample_vpsde,
    )
    from localregneuralde_tpu_torch.nn import product_tier
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    net = _score_net(device)
    # the demo's solvers: SOSRI at its default rtol = atol 1e-2
    # (scripts/vpsde_ab.py:57), Tsit5 at rtol 1e-4, atol 1e-6
    vp = functools.partial(sample_vpsde, solver="sosri")
    samplers = (("vpsde", vp, "persistent_vpsde_solve"),
                ("pf", sample_probability_flow, "persistent_pf_solve"))
    kw = dict(max_steps=SCORE_MAX_STEPS, device=device)
    for _, fn, _ in samplers:  # first-call set-up
        fn(None, (SCORE_B, SCORE_F), torch.Generator().manual_seed(99),
           score_module=net, **kw)
    torch.cuda.synchronize()

    # --- the main path: every launch from here to launch_counts() counts
    reset_launch_counts()
    draws = []
    for name, fn, _ in samplers:
        for i in range(SCORE_DRAWS):
            before, t0 = launch_counts(), time.perf_counter()
            s, sol = fn(None, (SCORE_B, SCORE_F),
                        torch.Generator().manual_seed(i), score_module=net,
                        **kw)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            after = launch_counts()
            draws.append((name, i, ms, s, sol,
                          {k: after[k] - before[k] for k in after
                           if after[k] != before[k]}))
    counts = launch_counts()
    counts = tier_counts()
    for name, i, ms, s, sol, c in draws:
        nfe = (f"nfe drift {int(sol.nfe_drift)} diffusion "
               f"{int(sol.nfe_diffusion)}" if name == "vpsde"
               else f"nfe {int(sol.nfe)}")
        print(f"[score sample {name}] draw {i}: {int(sol.naccept)} accepts "
              f"{int(sol.nreject)} rejects {nfe}, {ms:.3f} ms, "
              f"{SCORE_B / (ms / 1e3):.1f} samples/s, mean "
              f"{float(s.mean()):+.4f} std {float(s.std()):.4f} | launches {c}")
        kernel = dict((n, k) for n, _, k in samplers)[name]
        check(bool(sol.success) and tuple(s.shape) == (SCORE_B, SCORE_F)
              and bool(torch.isfinite(s).all()) and c == {kernel: 1},
              f"score sample {name} draw {i}: bad output or launches {c}")
    print(f"[score sample] launch counts "
          f"{ {k: v for k, v in counts.items() if v} }")
    tier = product_tier(None, device)
    check(all(counts.get(f"{k}[{tier}]", 0) == SCORE_DRAWS
              for _, _, k in samplers),
          f"score sample: the draws' kernels at {tier}: {counts}")

    # B = 256 on the card against the CPU at the card's tiers, the same
    # seed: the same draws, the same Philox path, so the same steps (the SDE
    # exactly; the ODE within one accept, its state bound then ten times
    # wider). At TF32 the two part by one evaluation's TF32 rounding more,
    # and the flow's steps, which TF32's noise in ũ sets at rtol 1e-4, may
    # differ: then the two draws are two solves of one ODE (5e-2 of max|y|)
    net_cpu = _score_net("cpu")
    extra = tf32_tol(SCORE_PRODUCTS) if tier == "tf32" else 0.0
    for name, fn, _ in samplers:
        a, sa = fn(None, (256, SCORE_F), torch.Generator().manual_seed(5),
                   score_module=net, **kw)
        with tiers_of(device):
            b, sb = fn(None, (256, SCORE_F), torch.Generator().manual_seed(5),
                       score_module=net_cpu, max_steps=SCORE_MAX_STEPS,
                       device="cpu")
        scale = float(b.abs().max())
        err = max_abs(a.cpu(), b)
        steps = [(int(x.naccept), int(x.nreject)) for x in (sa, sb)]
        print(f"[score sample {name}] B = 256, card vs CPU at the card's "
              f"tiers ({tier}): accepts/rejects {steps[0]} vs {steps[1]}, "
              f"max-abs {err:.3e} of max|y| {scale:.3e}")
        if name == "vpsde":
            ok = steps[0] == steps[1] and err <= (1e-3 + extra) * scale
        else:
            gap = abs(steps[0][0] - steps[1][0])
            ok = (err <= (5e-5 + extra) * scale if gap == 0
                  else gap <= 1 and err <= (5e-4 + extra) * scale
                  if tier == "fp32" else err <= 5e-2 * scale)
        check(ok and bool(torch.isfinite(a).all()),
              f"score sample {name}: card disagrees with the CPU")
    return counts


# Kernel 15's layouts before their Hopper redesign (the first port's FFMA
# kernels): each one's max-abs error against a float64 conv of
# [conv orient]'s inputs (max|y| 3.14), measured by this script's [conv
# orient fp64] on the first port (NVIDIA H100 80GB HBM3, 700 W): the
# redesign may at most double them.
K15_FP64_BEFORE = {"conv_orient_tap": 7.0203e-07,
                   "conv_orient_im2col": 3.2514e-06}
# The probe variants of lrnde_conv_orient_probe after the kernel itself
# (variant 0), in order
ORIENT_PROBES = ("64-pixel tiles", "hi·hi only (1xTF32)",
                 "A tiles by the threads' 4-byte copies",
                 "one wgmma accumulator")
# the probe variants that change the sums (printed against float64, not
# held bitwise to the kernel)
ORIENT_INEXACT = (2, 4)


def phase_conv_orient(device):
    """Kernel 15's two layouts at the probe's (32, 32, 32, 64): against the
    FP32 plain conv (cuDNN, 1e-5 of max|y|) and a float64 conv (twice the
    first port's error), bitwise repeatable, digested; timed beside kernel
    13's implicit GEMM and cuDNN; each layout's clocked instantiation
    (bitwise its untimed self) splits CTA 0's time by phase, and the probe
    variants (64-pixel tiles, hi·hi only, the threads' A path, one
    accumulator) are timed beside it. Returns the kernels' entries and their
    launch counts."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        conv_orient_im2col, conv_orient_plain, conv_orient_tap, launch_counts,
        reset_launch_counts,
    )

    b, h, w, c = 32, 32, 32, 64
    g = torch.Generator().manual_seed(1)
    x = torch.rand(b, h, w, c, generator=g).to(device)
    wt = (0.05 * torch.randn(3, 3, c, c, generator=g)).to(device)
    ref = conv_orient_plain(x, wt)
    ref64 = conv_orient_plain(x.double(), wt.double())
    wrappers = {"conv_orient_tap": conv_orient_tap,
                "conv_orient_im2col": conv_orient_im2col}
    # the probe's two launches, counted
    reset_launch_counts()
    outs = {k: fn(x, wt) for k, fn in wrappers.items()}
    counts = launch_counts()
    scale = float(ref.abs().max())
    errs = {k: max_abs(v, ref) for k, v in outs.items()}
    check(all(e <= 1e-5 * scale for e in errs.values()),
          f"conv orient vs cuDNN FP32: {errs} of {scale}")
    errs64 = {k: max_abs(v.double(), ref64) for k, v in outs.items()}
    print(f"[conv orient fp64] max-abs vs a float64 conv: "
          + ", ".join(f"{k} {e:.4e}" for k, e in errs64.items())
          + f"; cuDNN FP32 {max_abs(ref.double(), ref64):.4e} (max|y| "
          f"{float(ref64.abs().max()):.4e})"
          + ("" if K15_FP64_BEFORE is None else
             f"; the first port's {K15_FP64_BEFORE}"))
    if K15_FP64_BEFORE is not None:
        check(all(errs64[k] <= 2 * K15_FP64_BEFORE[k] for k in errs64),
              f"conv orient fp64: {errs64} past twice {K15_FP64_BEFORE}")
    for (k, fn), layout in zip(wrappers.items(), ("tap", "im2col")):
        check(torch.equal(fn(x, wt), outs[k]),
              f"conv orient {layout}: two launches differ")
        digest(f"K15 {layout}", outs[k])
    print("[conv orient] tap and im2col bitwise equal: "
          f"{torch.equal(*outs.values())}")
    sc = torch.zeros(2, device=device)
    out = torch.empty_like(ref)
    raws = [raw_launch(entry, x, wt, out, b, h, w, c, c)
            for entry in ("lrnde_conv_orient_tap", "lrnde_conv_orient_im2col")]
    raws.append(raw_launch("lrnde_conv_core", 0, 0, x, wt, sc, out,
                           torch.empty(1, device=device), b, h, w, c, c))
    check(all(r() == 0 for r in raws), "conv orient: raw launch failed")
    check(max_abs(out, ref) <= 1e-5 * scale, "conv core forward vs cuDNN")
    with torch.no_grad():
        times = back_to_back_ms(raws + [lambda: conv_orient_plain(x, wt)],
                                n=50, warmup=5)
        calls = median_ms([lambda: fn(x, wt) for fn in wrappers.values()])
    flops = 2 * b * h * w * 9 * c * c
    for name, ms in zip(("tap", "im2col", "conv core forward (K13, K14)",
                         "cuDNN FP32"), times):
        parent = PARENT_MS.get(f"K15 {name}")
        print(f"[conv orient] {name}: {1e3 * ms:.2f} µs per conv, "
              f"{flops / (ms / 1e3) / 1e12:.2f} TFLOP/s"
              + ("" if parent is None else f" (parent {1e3 * parent:.2f})"))
    print(f"[conv orient] max-abs vs cuDNN FP32 {errs} (max|y| {scale:.3e})")
    # in x and the weight, out y; the products as 3xTF32 on the tensor
    # cores, beside the FFMA bound of the first port's kind
    nbytes = 4 * (2 * x.numel() + wt.numel())
    ffma = bound(flops, nbytes)
    res = {}
    for (name, err), ms, call in zip(errs.items(), times, calls):
        r = dict(max_abs_err=err, ms=ms, plain_ms=times[3], call_ms=call,
                 **bound(3 * flops, nbytes, PEAK_TF32))
        r["library_ms"] = times[3]
        res[name] = r
        print(f"[conv orient] {name}: bound {r['bound_ms']:.4f} ms as 3xTF32 "
              f"(share {r['bound_ms'] / ms:.1%}), {ffma['bound_ms']:.4f} ms "
              f"as FFMA (share {ffma['bound_ms'] / ms:.1%}); one wrapper "
              f"call {call:.4f} ms")
    lib = _build_lib()
    if hasattr(lib, "lrnde_conv_orient_probe"):
        phase_orient_probe(lib, x, wt, outs, ref64, flops)
    return res, counts


def phase_orient_probe(lib, x, wt, outs, ref64, flops, runs=3):
    """Kernel 15 by phase and in its probe variants: each layout's clocked
    instantiation (CTA 0's consumer warpgroup 0, %globaltimer, the mean of
    ``runs`` launches) bitwise its untimed self; then each variant of
    ORIENT_PROBES (the threads' A path and 64-pixel tiles bitwise the
    kernel, hi·hi only and one accumulator against float64) timed back to
    back beside the kernel."""
    import torch

    b, h, w, c = x.shape
    phases = _phase_names(lib, "lrnde_conv_orient_phase_names")
    fns, labels = [], []
    for layout, name in enumerate(("tap", "im2col")):
        want = outs[f"conv_orient_{name}"]

        def timed(timing, layout=layout):
            y = torch.empty_like(want)
            check(raw_launch("lrnde_conv_orient_probe", layout, 0, x, wt, y,
                             b, h, w, c, c, timing)() == 0,
                  f"conv orient {name}: the clocked launch failed")
            return y

        y, per, _, _ = _clocked(timed, len(phases), x.device, runs)
        check(torch.equal(y, want),
              f"conv orient {name}: the clocked kernel's result differs")
        print(f"[conv orient attribution] {name}, CTA 0, µs (mean of {runs} "
              f"launches): " + ", ".join(f"{p} {v:.3f}"
                                         for p, v in zip(phases, per))
              + f"; sum {sum(per):.3f}; bitwise the untimed kernel")
        for variant, probe in enumerate(("the kernel", *ORIENT_PROBES)):
            y = torch.empty_like(want)
            fn = raw_launch("lrnde_conv_orient_probe", layout, variant, x,
                            wt, y, b, h, w, c, c, None)
            check(fn() == 0, f"conv orient {name} {probe}: launch failed")
            torch.cuda.synchronize()
            if variant in ORIENT_INEXACT:
                print(f"[conv orient probe] {name} {probe}: max-abs vs "
                      f"float64 {max_abs(y.double(), ref64):.4e}")
            else:
                check(torch.equal(y, want),
                      f"conv orient {name} {probe}: differs from the kernel")
            fns.append(fn)
            labels.append(f"{name} {probe}")
    ms = back_to_back_ms(fns, n=50, warmup=5)
    print("[conv orient probe] µs per conv back to back (TFLOP/s), the "
          "exact variants bitwise the kernel: " + "; ".join(
              f"{label} {1e3 * m:.2f} ({flops / (m / 1e3) / 1e12:.1f})"
              for label, m in zip(labels, ms)))
    n = len(ORIENT_PROBES) + 1
    for layout, name in enumerate(("tap", "im2col")):
        kernel, rows64 = ms[layout * n], ms[layout * n + 1]
        print(f"[conv orient grid] {name}: 128-pixel tiles (the kernel's) "
              f"{1e3 * kernel:.2f} µs, 64-pixel tiles {1e3 * rows64:.2f} µs: "
              + ("the kernel's tiles are faster" if kernel <= rows64
                 else "64-pixel tiles would be faster"))


# ---------------------------------------------------------------------------
# the K-step train call: one CUDA-graph replay of K captured train steps

CAPTURE_CALLS = 5      # timed calls per side (the median is printed)
PROFILE_EDGE = 256      # marker fills at each edge of a profiled window
PROFILE_GUARD_S = 0.1   # host pause between an edge's fills and its mark


def _generators(tree):
    import torch

    if isinstance(tree, torch.Generator):
        return [tree]
    if isinstance(tree, dict):
        return [g for v in tree.values() for g in _generators(v)]
    return []


def _train_leaves(ts):
    """(name, tensor) of everything a train step updates, in order: the
    parameters, the optimizer's state, the EMA and the layer state."""
    from localregneuralde_tpu_torch.harness.graph import _leaves

    out = [(f"param {k}", v) for k, v in ts.params.items()]
    for k, p in ts.params.items():
        out += [(f"opt {k} {n}", v)
                for n, v in ts.opt_state.state[p].items()]
    if ts.ema is not None:
        out += [(f"ema {k}", v) for k, v in ts.ema.items()]
    return out + [(f"state {i}", v) for i, v in enumerate(_leaves(ts.state))]


def _profiled(fn):
    """``fn()`` under ``torch.profiler``: (its result, the port kernels'
    launches, its device time in ms (kernels, copies, memsets), the edge
    fills the trace lost at its start and at its end). The trace can lose
    the device events at either edge of its window, never inside it
    (``sequence_split``): a step's first kernels, or a whole burst of
    fills launched last. So the work runs between two marks, each
    PROFILE_GUARD_S away from a burst of PROFILE_EDGE fills of an int16
    marker at the window's edge: opening burst, pause, opening mark,
    ``fn``, closing mark, pause, closing burst. The trace must hold the
    opening and the closing mark (the edges of the trace are the int16
    fills it kept of each burst with its mark), and only what lies between
    them is counted; the fills lost measure how near the edges came."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, dtype=torch.int16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_EDGE):
            marker.fill_(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)
        marker.fill_(2)
        out = fn()
        marker.fill_(3)
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)
        for _ in range(PROFILE_EDGE):
            marker.fill_(4)
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    is_mark = ["FillFunctor<short>" in e.name for e in dev]
    head = next((i for i, m in enumerate(is_mark) if not m), len(dev))
    tail = next((i for i, m in enumerate(reversed(is_mark)) if not m),
                len(dev))
    check(head >= 1 and tail >= 1 and head + tail < len(dev),
          f"profile: the trace keeps {head} and {tail} of the "
          f"{PROFILE_EDGE + 1} int16 fills at its edges, not both marks")
    work = dev[head:len(dev) - tail]
    counts = collections.Counter(e.name.split("(")[0][:80] for e in work
                                 if "lrnde" in e.name)
    busy = sum(e.device_time for e in work) / 1e3
    return (out, dict(counts), busy,
            (PROFILE_EDGE + 1 - head, PROFILE_EDGE + 1 - tail))


def _capture_configs(device):
    """(name, model, loss_fn, optimizer, w_regs, lrs, batches, reduce_fn)
    of each configuration the capture phase runs, with K = auto."""
    import numpy as np
    import torch

    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        construct_time_series, define_configuration, make_dataloader,
    )
    from localregneuralde_tpu_torch.harness.latent_runner import (
        build_physionet_arrays,
    )

    def cls_reduce(loss, stats, data):
        nfe = stats["nfe"]
        nfe = nfe[0] if isinstance(nfe, tuple) else nfe
        return {"loss": loss, "reg_val": stats["reg_val"],
                "nfe": nfe.float()}

    def cls(name, config, overrides, batches):
        cfg = define_configuration(overrides, config)
        model = construct_model(cfg, device=device)
        loss_fn, w_reg = construct_loss(cfg)
        opt, sched = construct_optimizer(cfg)
        return (name, cfg, model, loss_fn, opt,
                lambda k: np.asarray([w_reg(s + 1) for s in range(k)],
                                     np.float32),
                lambda k: np.asarray([sched(s + 1) for s in range(k)],
                                     np.float32), batches, cls_reduce)

    unb = ["--model.regularize=unbiased"]
    out = [cls("mlp.yaml", CONFIG, unb, lambda k: _mnist_batches(device, k,
                                                                 True)),
           cls("bench", CONFIG, BENCH + unb,
               lambda k: _mnist_batches(device, k, True)),
           cls("mnist_sde", SDE_CONFIG, unb,
               lambda k: _mnist_batches(device, k, True))]

    cfg = define_configuration([], LATENT_CONFIG)
    train, _, tgrid, _ = build_physionet_arrays(cfg)
    model = construct_time_series(cfg, saveat=torch.from_numpy(tgrid),
                                  device=device)
    loss_fn, (w_reg, w_kl) = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)

    def latent_batches(k):
        it = iter(make_dataloader(train, cfg.dataset.train_batchsize,
                                  shuffle=True, cycle=True, seed=cfg.seed))
        return [tuple(torch.from_numpy(a).to(device) for a in next(it))
                for _ in range(k)]

    def latent_reduce(loss, stats, data):
        return {"loss": loss, "reg_val": stats["reg_val"],
                "nfe": stats["nfe"].float()}

    out.append(("physionet", cfg, model, loss_fn, opt,
                lambda k: (np.asarray([w_reg(s + 1) for s in range(k)],
                                      np.float32),
                           np.asarray([w_kl(s + 1) for s in range(k)],
                                      np.float32)),
                lambda k: np.asarray([sched(s + 1) for s in range(k)],
                                     np.float32),
                latent_batches, latent_reduce))
    out.append(cls("cifar", CIFAR_CONFIG, unb,
                   lambda k: _cifar_batches(device, "train", k)))
    return out


def _eager_k(step, ts, batches, ws, lrs, reduce_fn):
    """K single train steps; the reduction summed in the K-step call's
    order."""
    red = None
    for k, data in enumerate(batches):
        w = (tuple(float(x[k]) for x in ws) if isinstance(ws, tuple)
             else float(ws[k]))
        ts, loss, stats = step(ts, data, w, float(lrs[k]))
        r = reduce_fn(loss, stats, data)
        red = r if red is None else {key: red[key] + r[key] for key in red}
    return ts, loss, red


def _compare_states(a, b, red_a, red_b):
    """The largest relative difference between two train states' tensors
    and reductions, and whether every tensor and generator is bitwise
    equal."""
    import torch

    la, lb = _train_leaves(a), _train_leaves(b)
    check([n for n, _ in la] == [n for n, _ in lb]
          and all(x.shape == y.shape and x.dtype == y.dtype
                  for (_, x), (_, y) in zip(la, lb)),
          "capture: the train states differ in layout")
    pairs = [(x, y) for (_, x), (_, y) in zip(la, lb)]
    pairs += [(red_a[k], red_b[k]) for k in red_a]
    bitwise = all(torch.equal(x, y) for x, y in pairs)
    gens = all(torch.equal(g.get_state(), h.get_state())
               for g, h in zip(_generators(a.state), _generators(b.state)))
    worst = 0.0
    for x, y in pairs:
        if x.is_floating_point():
            scale = max(float(y.abs().max()), 1e-30)
            worst = max(worst, float((x - y).abs().max()) / scale)
    return bitwise, gens, worst


def phase_capture(device, only=None):
    """The K-step train call against K eager train steps at full width:
    ``mlp.yaml`` and the bench tolerance (both unbiased), the MNIST SDE
    (unbiased), PhysioNet as shipped and CIFAR-10 (unbiased), each with K =
    auto. Holds the call's train state (parameters, optimizer state, layer
    state, the CPU generators) and its summed loss, reg_val and NFE
    against K ``make_train_step`` calls from a copy of the same state on
    the same batches, w_reg and learning rates: bitwise, where the call is
    one CUDA-graph replay and for CIFAR's eager call alike (its plain
    convs take cuDNN's deterministic algorithms inside the port,
    ``nn.basic.conv2d_nhwc``; no process-wide flag is set here, and two
    eager runs are held bitwise against each other). Counts the port's
    kernels of one replay and of K eager steps with ``torch.profiler``,
    each in a marked window (``_profiled``), times both (the median of
    CAPTURE_CALLS calls a side) and prints the replay's device-busy share;
    then one captured call with
    ``grad_accumulation=2`` and ``ema_decay=0.999`` on ``mlp.yaml`` against
    its eager twin. ``only``: the names of the configurations to run
    (default all, and the grad_accumulation and EMA call). Returns the port
    kernels' launch counts of the captured calls, by wrapper."""
    import copy

    import torch

    from localregneuralde_tpu_torch.harness import (
        create_train_state, init_ema, make_multi_train_step, make_train_step,
    )
    from localregneuralde_tpu_torch.harness.graph import capturable
    from localregneuralde_tpu_torch.harness.loop import (
        resolve_steps_per_call,
    )
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    reset_launch_counts()
    rows = []
    for (name, cfg, model, loss_fn, opt, ws_of, lrs_of, batches_of,
         reduce_fn) in _capture_configs(device):
        if only is not None and name not in only:
            continue
        t = cfg.train
        bs = cfg.dataset.train_batchsize
        cap = capturable(model, bs, device)
        K = resolve_steps_per_call(0, t.print_frequency, t.evaluate_every,
                                   capturable=True)
        check(K == 5, f"capture {name}: auto K is {K}, expected 5")
        check(cap == (name != "cifar"),
              f"capture {name}: the route predicate says {cap}")
        batches = batches_of(2 * K)
        ws, lrs = ws_of(K), lrs_of(K)
        stack = tuple(torch.stack([b[i] for b in batches[:K]])
                      for i in range(len(batches[0])))
        step = make_train_step(model, loss_fn, opt)
        multi = make_multi_train_step(model, loss_fn, opt, reduce_fn)
        ts0 = create_train_state(model, opt)
        a, loss_a, red_a = _eager_k(step, copy.deepcopy(ts0), batches[:K],
                                    ws, lrs, reduce_fn)
        b, loss_b, red_b = multi(copy.deepcopy(ts0), stack, ws, lrs)
        torch.cuda.synchronize()
        check(multi.captured == cap,
              f"capture {name}: captured {multi.captured}, expected {cap}")
        bitwise, gens, worst = _compare_states(a, b, red_a, red_b)
        check(gens, f"capture {name}: the CPU generators differ")
        nfe_a, nfe_b = int(red_a["nfe"]), int(red_b["nfe"])
        head = (f"[capture {name}] K={K} captured={multi.captured}: summed "
                f"loss {float(red_b['loss']):.6f} vs eager "
                f"{float(red_a['loss']):.6f}, reg_val "
                f"{float(red_b['reg_val']):.6e} vs "
                f"{float(red_a['reg_val']):.6e}, NFE {nfe_b} vs {nfe_a}")
        print(f"{head}; bitwise {bitwise} (parameters, optimizer and "
              "layer state, generators, loss, reg_val, NFE)")
        check(bitwise, f"capture {name}: the call differs from {K} eager "
              f"steps (largest relative difference {worst:.3e})")
        if not cap:
            # the eager call repeats only if eager steps repeat: a second
            # eager run from the same state, with no flag set
            a2, _, red_a2 = _eager_k(step, copy.deepcopy(ts0), batches[:K],
                                     ws, lrs, reduce_fn)
            rep, gens2, worst2 = _compare_states(a, a2, red_a, red_a2)
            print(f"[capture {name}] two eager runs of {K} steps from one "
                  f"state: bitwise {rep} (generators {gens2}, largest "
                  f"relative difference {worst2:.3e})")
            check(rep and gens2, f"capture {name}: eager steps are not "
                  "repeatable")
            del a2
        # launches of the port's kernels: K eager steps against one call,
        # from the same state on the same batches
        nxt = batches[K:]
        nstack = tuple(torch.stack([x[i] for x in nxt])
                       for i in range(len(nxt[0])))
        a, ka, _, lost_a = _profiled(
            lambda: _eager_k(step, a, nxt, ws, lrs, reduce_fn)[0])
        before = launch_counts()

        def timed_call():
            t0 = time.perf_counter()
            out = multi(b, nstack, ws, lrs)[0]
            torch.cuda.synchronize()
            return out, 1e3 * (time.perf_counter() - t0)

        (b, wall), kb, busy, lost_b = _profiled(timed_call)
        print(f"[capture {name}] port kernels of {K} eager steps {ka}; of "
              f"one call {kb}; the call {wall:.3f} ms under the profiler, "
              f"device busy {busy:.3f} ms ({100 * busy / wall:.1f}%); the "
              f"traces lost {lost_a} and {lost_b} of the {PROFILE_EDGE + 1} "
              "int16 fills at each edge (start, end)")
        check(bool(kb), f"capture {name}: the profiler saw no port kernel")
        if cap:
            check(ka == kb, f"capture {name}: the replay's kernels differ "
                  "from the eager steps'")
            check(launch_counts() == before,
                  f"capture {name}: a replay went through a wrapper")
        else:
            check(set(ka) == set(kb), f"capture {name}: kernels differ")
        # ms a step, eager and captured (the median of CAPTURE_CALLS calls)
        times = {"eager": [], "call": []}
        for _ in range(CAPTURE_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a, _, _ = _eager_k(step, a, nxt, ws, lrs, reduce_fn)
            torch.cuda.synchronize()
            times["eager"].append(1e3 * (time.perf_counter() - t0) / K)
            t0 = time.perf_counter()
            b, _, _ = multi(b, nstack, ws, lrs)
            torch.cuda.synchronize()
            times["call"].append(1e3 * (time.perf_counter() - t0) / K)
        e_ms = statistics.median(times["eager"])
        c_ms = statistics.median(times["call"])
        print(f"[capture {name}] ms a step: eager {e_ms:.3f} (min "
              f"{min(times['eager']):.3f}, max {max(times['eager']):.3f}), "
              f"K-step call {c_ms:.3f} (min {min(times['call']):.3f}, max "
              f"{max(times['call']):.3f}); device busy a step "
              f"{busy / K:.3f} ms")
        rows.append(dict(name=name, K=K, captured=multi.captured,
                         bitwise=bitwise, eager_ms=e_ms, call_ms=c_ms,
                         busy_ms=busy / K, busy_share=busy / wall))
        del a, b, multi, step, ts0, batches, stack, nstack, nxt
        gc.collect()
        torch.cuda.empty_cache()

    if only is not None:
        print(json.dumps({"capture": rows}))
        return tier_counts()
    # grad_accumulation=2 and the params-EMA on mlp.yaml, captured
    name, cfg, model, loss_fn, opt, ws_of, lrs_of, batches_of, reduce_fn = (
        _capture_configs(device)[0])
    K = 5
    batches = batches_of(K)
    ws, lrs = ws_of(K), lrs_of(K)
    stack = tuple(torch.stack([x[i] for x in batches])
                  for i in range(len(batches[0])))
    kw = dict(grad_accumulation=2, ema_decay=0.999)
    step = make_train_step(model, loss_fn, opt, **kw)
    multi = make_multi_train_step(model, loss_fn, opt, reduce_fn, **kw)
    ts0 = init_ema(create_train_state(model, opt))
    a, _, red_a = _eager_k(step, copy.deepcopy(ts0), batches, ws, lrs,
                           reduce_fn)
    b, _, red_b = multi(copy.deepcopy(ts0), stack, ws, lrs)
    torch.cuda.synchronize()
    bitwise, gens, worst = _compare_states(a, b, red_a, red_b)
    print(f"[capture mlp.yaml ga=2 ema=0.999] captured={multi.captured}: "
          f"summed loss {float(red_b['loss']):.6f} vs eager "
          f"{float(red_a['loss']):.6f}, NFE {int(red_b['nfe'])} vs "
          f"{int(red_a['nfe'])}; bitwise {bitwise} (EMA included), "
          f"generators {gens}")
    check(multi.captured and bitwise and gens,
          "capture: grad_accumulation=2 with the EMA differs from eager "
          f"(largest relative difference {worst:.3e})")
    del a, b, multi, step, ts0
    gc.collect()
    torch.cuda.empty_cache()
    print(json.dumps({"capture": rows}))
    return tier_counts()


# ------------------------------------------------------------ the TF32 tier

def phase_tf32(device, w, x):
    """The TD-MLP family at the TF32 tier (the reference's 'default'
    precision, which 'auto' takes at rtol ≥ 1e-4): kernels 1, 2, 4, 3, 7
    and 8 at TF32 against their TF32 plain versions on the same inputs (the
    operands rounded as the kernels round them, the sums in FP32; the gates
    in the module docstring, item 19), beside the FP32 results across tiers
    (``tf32_tol``); the six TF32 digests; the forced TF32 replay bitwise its
    forward; then the bench configuration's serving batches and train steps
    through 'auto' (TF32) and 'highest' (FP32), and mlp.yaml's train step
    under grad_precision 'match' and 'default', each against the CPU at the
    card's tiers, with launch counts by tier (counted from zero before each
    path, read after it). Returns (the kernels line's TF32 rows, the paths'
    launch counts with tiers)."""
    import torch

    from localregneuralde_tpu_torch.harness import warmup_model
    from localregneuralde_tpu_torch.ode.stored_adjoint import knot_layout
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_step_bwd, fused_step_bwd_plain, fused_tdmlp, fused_tsit5_step,
        persistent_stored_sweep, persistent_stored_sweep_plain,
        persistent_tsit5_solve, persistent_tsit5_solve_plain,
        persistent_two_level_sweep, persistent_two_level_sweep_plain,
        reset_launch_counts, tdmlp_plain, tsit5_step_plain,
    )

    res = {}
    tf = dict(precision=None)
    wb = tdmlp_weight_bytes()

    # kernel 1
    y = fused_tdmlp(w, x, 0.3, **tf)
    ref = tdmlp_plain(w, x, 0.3, "tf32")
    err, rel = max_abs(y, ref), rel_err(y, ref)
    xt = rel_err(y, tdmlp_plain(w, x, 0.3))
    print(f"[tf32 K1] vs the TF32 plain version max-abs {err:.3e}, relative "
          f"{rel:.3e} (tolerance {tf32_sum_tol(2):.3e}); vs FP32 (across "
          f"tiers) relative {xt:.3e}, tolerance {tf32_tol(2):.3e}")
    check(rel <= tf32_sum_tol(2), f"tdmlp tf32 vs plain: relative {rel}")
    check(xt <= tf32_tol(2), f"tdmlp tf32 vs fp32: {xt}")
    digest("K1 tf32", *[fused_tdmlp(w, x[:b], s, **tf) for b in (B, 410)
                        for s in (0.0, 0.3)])
    raw = raw_launch("lrnde_tdmlp_tf32", x, torch.tensor([0.3], device=device),
                     *w, torch.empty_like(x), B, F, H, 0)
    check(raw() == 0, "tdmlp tf32: raw launch failed")
    ms, plain = back_to_back_ms([raw, lambda: tdmlp_plain(w, x, 0.3, "tf32")])
    res["tdmlp_tf32"] = dict(max_abs_err=err, ms=ms, plain_ms=plain,
                             **bound(tdmlp_flops(), 8 * B * F + wb, PEAK_TF32))

    # kernel 2
    t = torch.tensor(0.2, device=device)
    dt = torch.tensor(0.05, device=device)
    k1 = tdmlp_plain(w, x, t, "tf32")
    out = fused_tsit5_step(w, x, t, dt, k1, **tf)
    ref = tsit5_step_plain(w, x, t, dt, k1, "tf32")
    fp = tsit5_step_plain(w, x, t, dt, k1)
    # every output but ũ (out[1]) against its own scale; ũ cancels
    err = max(max_abs(a, b) for a, b in zip(out, ref))
    rel = max(rel_err(a, b) for i, (a, b) in enumerate(zip(out, ref))
              if i != 1)
    xt = max(rel_err(a, b) for i, (a, b) in enumerate(zip(out, fp))
             if i != 1)
    ut_ok = utilde_ok(out[1], ref[1], out[2:8], ref[2:8], dt)
    ut_xt = utilde_ok(out[1], fp[1], out[2:8], fp[2:8], dt)
    print(f"[tf32 K2] vs the TF32 plain version max-abs {err:.3e}, relative "
          f"{rel:.3e} but ũ (tolerance {tf32_sum_tol(12):.3e}), ũ within "
          f"dt·max|Δk| {ut_ok}; vs FP32 (across tiers) relative {xt:.3e} "
          f"(tolerance {tf32_tol(12):.3e}), ũ within dt·max|Δk| {ut_xt}")
    check(rel <= tf32_sum_tol(12) and ut_ok,
          f"tsit5_step tf32 vs plain: relative {rel}")
    check(xt <= tf32_tol(12) and ut_xt, f"tsit5_step tf32 vs fp32: {xt}")
    digest("K2 tf32", *[o for b in (B, 410) for o in fused_tsit5_step(
        w, x[:b], t, dt, fused_tdmlp(w, x[:b], t, **tf), **tf)])
    raw = raw_launch("lrnde_tsit5_step_tf32",
                     *step_raw_args(w, x, k1, t, dt)[:-1])
    check(raw() == 0, "tsit5_step tf32: raw launch failed")
    ms, plain = back_to_back_ms(
        [raw, lambda: tsit5_step_plain(w, x, t, dt, k1, "tf32")])
    res["tsit5_step_tf32"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound(6 * tdmlp_flops(), 44 * B * F + wb, PEAK_TF32))

    # kernel 4 at the bench tolerance, and its refusal below rtol 1e-4
    saveat = torch.tensor([0.5, 1.0], device=device)
    kw = dict(rtol=1e-4, atol=1e-4, saveat_arr=saveat, max_steps=64)
    out = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw, **tf)
    digest("K4 bench tf32", out)
    ref = persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw, tier="tf32")
    fp = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw)
    err, rel = max_abs(out["ys"], ref["ys"]), rel_err(out["ys"], ref["ys"])
    na, nb, nf = (int(o["naccept"]) for o in (out, ref, fp))
    fa, fb, ff = (int(o["nfe"]) for o in (out, ref, fp))
    xt = rel_err(out["ys"], fp["ys"])
    # the step controller reads TF32's noise in ũ, so the kernel and the
    # loop take steps of their own: one evaluation's TF32 rounding, same
    # tier or across (logits_tol)
    tol = tf32_tol(EVAL_PRODUCTS)
    print(f"[tf32 K4 bench] kernel naccept {na} nfe {fa} | TF32 loop "
          f"naccept {nb} nfe {fb} | ys max-abs {err:.3e}, relative {rel:.3e} "
          f"(tolerance {tol:.3e}); FP32 kernel naccept {nf} nfe {ff}, ys "
          f"relative {xt:.3e} (across tiers, tolerance {tol:.3e})")
    check(bool(out["success"]) and bool(ref["success"])
          and rel <= tol and abs(na - nb) <= 1 and abs(fa - fb) <= 12,
          "persistent solve tf32 disagrees with the TF32 loop")
    check(xt <= tol, f"persistent solve tf32 vs fp32: {xt}")
    try:
        persistent_tsit5_solve(w, x, (0.0, 1.0), rtol=1.4e-8, atol=1.4e-8,
                               saveat_arr=saveat, max_steps=16, **tf)
        refused = False
    except ValueError:
        refused = True
    check(refused, "the TF32 solve ran below rtol 1e-4")
    print("[tf32 K4] refuses rtol 1.4e-8 (ValueError)")
    ms, plain = median_ms(
        [lambda: persistent_tsit5_solve(w, x, (0.0, 1.0), **kw, **tf),
         lambda: persistent_tsit5_solve_plain(w, x, (0.0, 1.0), **kw,
                                              tier="tf32")], n=10, warmup=1)
    res["persistent_tsit5_solve_tf32"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound(tdmlp_flops() * (fa - 2), 4 * 5 * B * F + wb, PEAK_TF32))
    raws = [solve_raw(w, x, 1e-4, 64, "tf32"), solve_raw(w, x, 1e-4, 64)]
    check(all(r() == 0 for r in raws), "tf32 K4: raw launch failed")
    alone = back_to_back_ms(raws, n=20, warmup=2)
    print(f"[tf32 K4 attribution] the kernel alone at the bench tolerance, "
          f"device ms per launch: TF32 {alone[0]:.4f} "
          f"({1e3 * alone[0] / ((fa - 2) // 6):.1f} µs an attempt, NFE {fa}), "
          f"FP32 {alone[1]:.4f} ({1e3 * alone[1] / ((ff - 2) // 6):.1f} µs, "
          f"NFE {ff}); one wrapper call at TF32 {ms:.4f}")

    # kernel 3: the bench's route (TF32 throughout) and mlp.yaml's (FP32
    # recompute, TF32 gradients)
    g = torch.Generator(device=device).manual_seed(7)
    k1 = tdmlp_plain(w, x, t)
    cts = [torch.randn(x.shape, generator=g, device=device) for _ in range(9)]
    fp = fused_step_bwd(w, x, t, dt, k1, cts)

    def flat3(o):
        return [o[1], o[2], *o[0]]

    for label, prec, tiers in (("tf32", None, ("tf32", "tf32")),
                               ("tf32grads", "highest", ("fp32", "tf32"))):
        ours = fused_step_bwd(w, x, t, dt, k1, cts, precision=prec,
                              grad_precision=None)
        ref = fused_step_bwd_plain(w, x, t, dt, k1, cts, *tiers)
        rel = max(rel_err(a, b) for a, b in zip(flat3(ours), flat3(ref)))
        err = max(max_abs(a, b) for a, b in zip(flat3(ours), flat3(ref)))
        xt = max(rel_err(a, b) for a, b in zip(flat3(ours), flat3(fp)))
        again = fused_step_bwd(w, x, t, dt, k1, cts, precision=prec,
                               grad_precision=None)
        same = all(torch.equal(a, b) for a, b in zip(flat3(again),
                                                     flat3(ours)))
        print(f"[tf32 K3 {'/'.join(tiers)}] (recompute/gradients) relative "
              f"max-abs vs its plain version {rel:.3e} (tolerance "
              f"{tf32_sum_tol(25):.3e}), bitwise repeatable {same}; vs FP32 "
              f"(across tiers) {xt:.3e}, tolerance {tf32_tol(25):.3e}")
        check(rel <= tf32_sum_tol(25) and same,
              f"step_bwd {label} vs plain: {rel}")
        check(xt <= tf32_tol(25), f"step_bwd {label} vs fp32: {xt}")
        if label == "tf32":
            digest("K3 tf32", *ours[0], ours[1], ours[2])
        bits = 3 if label == "tf32" else 2
        raw = raw_launch("lrnde_tsit5_step_bwd_tiered", bits,
                         *step_bwd_raw_args(w, x, k1, torch.stack([t, dt]),
                                            cts))
        check(raw() == 0, f"step_bwd {label}: raw launch failed")
        ms, plain = back_to_back_ms(
            [raw, lambda: fused_step_bwd_plain(w, x, t, dt, k1, cts, *tiers)],
            n=50)
        # six evaluations recomputed, twelve transposed (two products a
        # stage and the weight gradients), each at its tier
        rec = 6 * tdmlp_flops()
        res[f"tsit5_step_bwd_{label}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain,
            **mixed_bound(0 if prec is None else rec,
                          12 * tdmlp_flops() + (rec if prec is None else 0),
                          52 * B * F + 2 * wb))

    # kernel 7 over kernel 4's TF32 knots at the bench tolerance
    ct_ys = torch.randn((2, B, F), generator=g, device=device)
    ct_y = torch.randn((B, F), generator=g, device=device)
    dense_cap, _, stride = knot_layout(64)
    rec = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw, record_knots=True,
                                 knot_dense_cap=dense_cap, knot_stride=stride,
                                 **tf)

    def sweep_args(r):
        return (w, r["knot_ts"], r["knot_us"], r["naccept"], saveat, ct_ys,
                ct_y)

    def ckpt_args(r):
        return tuple(r[k] for k in ("ckpt_ts", "ckpt_us", "ckpt_ks",
                                    "ckpt_dts", "ckpt_qolds"))

    def flat(o):
        return [o[0], o[1], *o[2]]

    all_tf = dict(precision=None, grad_precision=None)
    n = int(rec["naccept"])
    dense = persistent_stored_sweep(*sweep_args(rec), **all_tf)
    ref = persistent_stored_sweep_plain(*sweep_args(rec),
                                        recompute_tier="tf32",
                                        grad_tier="tf32")
    rel = max(rel_err(a, b) for a, b in zip(flat(dense), flat(ref)))
    err = max(max_abs(a, b) for a, b in zip(flat(dense), flat(ref)))
    xt = max(rel_err(a, b) for a, b in zip(
        flat(dense), flat(persistent_stored_sweep(*sweep_args(rec)))))
    again = persistent_stored_sweep(*sweep_args(rec), **all_tf)
    same = all(torch.equal(a, b) for a, b in zip(flat(again), flat(dense)))
    worst, by = against_plains(flat(dense), flat(ref), flat(
        persistent_stored_sweep_plain(*on_cpu(sweep_args(rec)),
                                      recompute_tier="tf32",
                                      grad_tier="tf32")))
    fp_by = {nm: f"{rel_err(a, b):.2e}" for nm, a, b in zip(
        SWEEP_OUTPUTS, flat(dense),
        flat(persistent_stored_sweep(*sweep_args(rec))))}
    # same tier: against_plains; across tiers, the FP32 sweep on the same
    # knots (the shared-knot comparison of the bench's 'auto' and 'highest'
    # gradients): one transposed step's TF32 rounding
    print(f"[tf32 K7 bench] {n} steps: relative max-abs vs its plain version "
          f"{rel:.3e}; vs the CPU's plain version / the card's plain vs the "
          f"CPU's {by}: at most {worst:.3f} of the gate (twice the plains' "
          f"distance, at least {tf32_sum_tol(STEP_BWD_PRODUCTS):.3e}), "
          f"bitwise repeatable {same}; vs the FP32 sweep on the same knots "
          f"(across tiers) {xt:.3e} {fp_by} (tolerance "
          f"{tf32_tol(STEP_BWD_PRODUCTS):.3e})")
    check(worst <= 1 and same, f"dense sweep tf32 vs plain: {by}")
    check(xt <= tf32_tol(STEP_BWD_PRODUCTS),
          f"dense sweep tf32 vs fp32: {xt}")
    ms, plain = median_ms(
        [lambda: persistent_stored_sweep(*sweep_args(rec), **all_tf),
         lambda: persistent_stored_sweep_plain(
             *sweep_args(rec), recompute_tier="tf32", grad_tier="tf32")],
        n=10, warmup=1)
    res["persistent_stored_sweep_tf32"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound(19 * n * tdmlp_flops(),
                4 * (n + 1 + 3 + 2) * B * F + 2 * wb, PEAK_TF32))

    # kernel 8 as mlp.yaml's train step runs it (FP32 forward knots, the
    # dense branch): TF32 gradients behind an FP32 recompute
    # (grad_precision 'match') or a TF32 one ('default')
    kw_m = dict(rtol=1.4e-8, atol=1.4e-8, saveat_arr=saveat, max_steps=10000)
    cap_m, _, stride_m = knot_layout(10000)
    rec_m = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw_m,
                                   record_knots=True, knot_dense_cap=cap_m,
                                   knot_stride=stride_m)
    n_m = int(rec_m["naccept"])
    tl = dict(t_end=1.0, rtol=1.4e-8, atol=1.4e-8, max_steps=10000,
              stride=stride_m, dense_cap=cap_m)
    fp32 = persistent_two_level_sweep(*sweep_args(rec_m), *ckpt_args(rec_m),
                                      **tl)
    for label, rp, rec_tier in (("match", "highest", "fp32"),
                                ("default", None, "tf32")):
        tiers = dict(precision="highest", grad_precision=None,
                     recompute_precision=rp)
        ours = persistent_two_level_sweep(*sweep_args(rec_m),
                                          *ckpt_args(rec_m), **tl, **tiers)
        ref = persistent_stored_sweep_plain(*sweep_args(rec_m),
                                            recompute_tier=rec_tier,
                                            grad_tier="tf32")
        rel = max(rel_err(a, b) for a, b in zip(flat(ours), flat(ref)))
        err = max(max_abs(a, b) for a, b in zip(flat(ours), flat(ref)))
        xt = max(rel_err(a, b) for a, b in zip(flat(ours), flat(fp32)))
        ms, fp_ms, plain = median_ms(
            [lambda: persistent_two_level_sweep(
                *sweep_args(rec_m), *ckpt_args(rec_m), **tl, **tiers),
             lambda: persistent_two_level_sweep(
                 *sweep_args(rec_m), *ckpt_args(rec_m), **tl),
             lambda: persistent_stored_sweep_plain(
                 *sweep_args(rec_m), recompute_tier=rec_tier,
                 grad_tier="tf32")], n=10, warmup=1)
        worst, by = against_plains(flat(ours), flat(ref), flat(
            persistent_stored_sweep_plain(*on_cpu(sweep_args(rec_m)),
                                          recompute_tier=rec_tier,
                                          grad_tier="tf32")))
        # across tiers per transposed step: its gradient products, and its
        # recompute's under 'default'
        x_tol = tf32_tol(GRAD_PRODUCTS + (STEP_BWD_PRODUCTS - GRAD_PRODUCTS
                                          if rec_tier == "tf32" else 0))
        print(f"[tf32 K8 mlp.yaml grad_precision={label}] {n_m} steps "
              f"(recompute {rec_tier}, gradients tf32): relative max-abs vs "
              f"its plain version {rel:.3e}; vs the CPU's plain version / "
              f"the card's plain vs the CPU's {by}: at most {worst:.3f} of "
              f"the gate; the gradients vs the FP32 sweep (across tiers) "
              f"{xt:.3e}, tolerance {x_tol:.3e}; device {ms:.3f} ms a "
              f"launch, the FP32 sweep {fp_ms:.3f} ms")
        check(worst <= 1, f"kernel 8 {label} vs plain: {by}")
        check(xt <= x_tol, f"kernel 8 {label} vs fp32: {xt}")
        if label == "match":
            digest("K8 grads tf32", *flat(ours))
            res["persistent_two_level_sweep_dense_tf32grads"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain,
                **mixed_bound(7 * n_m * tdmlp_flops(),
                              12 * n_m * tdmlp_flops(),
                              4 * (n_m + 1 + 3 + 2) * B * F + 2 * wb))

    # kernel 8's replay at the TF32 tier, forced (capacity 2, W = 4) over
    # kernel 4's TF32 forward at the bench tolerance
    w4 = persistent_tsit5_solve(w, x, (0.0, 1.0), **kw, record_knots=True,
                                knot_dense_cap=dense_cap, knot_stride=4, **tf)
    n4 = int(w4["naccept"])
    check(n4 > 2, "the bench solve is too short to force the replay")
    tl_b = dict(t_end=1.0, rtol=1e-4, atol=1e-4, max_steps=64, stride=4,
                dense_cap=2)
    win, replay = persistent_two_level_sweep(
        *sweep_args(w4), *ckpt_args(w4), **tl_b, return_replay=True,
        **all_tf)
    m = min(n4, 4)
    rep_ok = torch.equal(replay[:m + 1], w4["knot_us"][:m + 1])
    digest("K8 replay tf32", replay[:m + 1], n4)
    dense4 = persistent_stored_sweep(*sweep_args(w4), **all_tf)
    rel = max(rel_err(a, b) for a, b in zip(flat(win), flat(dense4)))
    same = all(torch.equal(a, b) for a, b in zip(flat(win), flat(dense4)))
    plain_w = persistent_two_level_sweep_plain(
        *sweep_args(w4), *ckpt_args(w4), **tl_b, tier="tf32",
        recompute_tier="tf32", grad_tier="tf32")
    rel_p = max(rel_err(a, b) for a, b in zip(flat(win), flat(plain_w)))
    err = max(max_abs(a, b) for a, b in zip(flat(win), flat(plain_w)))
    worst, by = against_plains(flat(win), flat(plain_w), flat(
        persistent_two_level_sweep_plain(
            *on_cpu(sweep_args(w4) + ckpt_args(w4)), **tl_b, tier="tf32",
            recompute_tier="tf32", grad_tier="tf32")))
    print(f"[tf32 K8 replay] {n4} accepts, replay forced (capacity 2, W = "
          f"4): window 0 replayed from checkpoint 0 bitwise its TF32 forward "
          f"{rep_ok}; gradients vs the dense TF32 sweep relative max-abs "
          f"{rel:.3e}, bitwise {same}; vs the plain TF32 two-level sweep "
          f"{rel_p:.3e}; vs the CPU's / the card's plain vs the CPU's {by}: "
          f"at most {worst:.3f} of the gate")
    check(rep_ok, "the TF32 replay does not repeat its forward bitwise")
    check(rel <= 1e-6, f"two-level tf32 sweep vs dense: {rel}")
    check(worst <= 1, f"two-level tf32 sweep vs plain: {by}")
    ms, plain = median_ms(
        [lambda: persistent_two_level_sweep(*sweep_args(w4), *ckpt_args(w4),
                                            **tl_b, **all_tf),
         lambda: persistent_two_level_sweep_plain(
             *sweep_args(w4), *ckpt_args(w4), **tl_b, tier="tf32",
             recompute_tier="tf32", grad_tier="tf32")], n=5, warmup=1)
    att = (int(w4["nfe"]) - 2) // 6
    res["persistent_two_level_sweep_tf32"] = dict(
        max_abs_err=err, ms=ms, plain_ms=plain,
        **bound((6 * att + 19 * n4) * tdmlp_flops(),
                4 * (2 + 3 + 2) * B * F + 2 * wb, PEAK_TF32))

    # --- the bench configuration: 'auto' (TF32) and 'highest' (FP32)
    hi = ["--model.solver.precision=highest"]
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    batches = _mnist_batches(device, N_BATCHES)
    m_auto = _slice_model(BENCH, device)
    m_hi = _slice_model(BENCH + hi, device, m_auto[0].state_dict())
    for m_ in (m_auto, m_hi):
        m_[1](m_[2], batches[0], m_[3])
    torch.cuda.synchronize()
    served = {}
    for arm, (model, step, ts, w_reg) in (("auto", m_auto), ("highest", m_hi)):
        reset_launch_counts()
        outs = []
        for i, data in enumerate(batches):
            t0 = time.perf_counter()
            loss, stats = step(ts, data, w_reg)
            torch.cuda.synchronize()
            outs.append((loss, stats, 1e3 * (time.perf_counter() - t0)))
        c = tier_counts()
        if arm == "auto":
            add(c)
        served[arm] = outs
        for i, (loss, stats, ms) in enumerate(outs):
            print(f"[tf32 serve bench {arm}] batch {i}: loss "
                  f"{float(loss):.6f} NFE {int(stats['nfe'])} success "
                  f"{bool(stats['solver_success'])} {ms:.3f} ms")
            check(bool(stats["solver_success"])
                  and bool(torch.isfinite(stats["y_pred"]).all()),
                  f"tf32 serve {arm} batch {i}: bad output")
        print(f"[tf32 serve bench {arm}] launches "
              f"{ {k: v for k, v in c.items() if '[' in k} }")
        tier = "tf32" if arm == "auto" else "fp32"
        nb = len(batches)
        check(c.get(f"persistent_tsit5_solve[{tier}]") == nb
              and c.get(f"tdmlp[{tier}]") == 2 * nb
              and c["persistent_tsit5_solve"] == nb and c["tdmlp"] == 2 * nb,
              f"tf32 serve {arm}: launches {c}")
    for i in range(len(batches)):
        a, h = served["auto"][i][1], served["highest"][i][1]
        rel = rel_err(a["y_pred"], h["y_pred"])
        tol, _ = logits_tol(("tf32",), ("fp32",))
        print(f"[tf32 serve bench] batch {i}: NFE auto {int(a['nfe'])} vs "
              f"highest {int(h['nfe'])}; logits relative max-abs {rel:.3e} "
              f"(across tiers, tolerance {tol:.3e})")
        check(rel <= tol, f"tf32 serve batch {i}: logits across tiers {rel}")

    tb = _mnist_batches(device, TRAIN_STEPS, train=True)
    tr_auto = _train_setup(BENCH, device)
    sd = tr_auto[0].state_dict()
    params0 = {k: v.detach().clone() for k, v in tr_auto[3].params.items()}
    tr_hi = _train_setup(BENCH + hi, device, sd)
    grads = {}
    for arm, (model, loss_fn, step, ts, w_reg, sched) in (
            ("auto", tr_auto), ("highest", tr_hi)):
        grads[arm] = _grads(model, loss_fn, params0, tb[0], w_reg(1))
        warmup_model(step, None, ts, tb[0], w_reg(1), sched(1))
        torch.cuda.synchronize()
        reset_launch_counts()
        for i, data in enumerate(tb):
            t0 = time.perf_counter()
            ts, loss, stats = step(ts, data, w_reg(i + 1), sched(i + 1))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            print(f"[tf32 train bench {arm}] step {i}: loss {float(loss):.6f} "
                  f"reg_val {float(stats['reg_val']):.6e} NFE "
                  f"{int(stats['nfe'])} success "
                  f"{bool(stats['solver_success'])} {ms:.3f} ms")
            check(bool(torch.isfinite(loss))
                  and bool(stats["solver_success"]),
                  f"tf32 train {arm} step {i}: bad output")
        c = tier_counts()
        print(f"[tf32 train bench {arm}] launches "
              f"{ {k: v for k, v in c.items() if '[' in k} }")
        if arm == "auto":
            add(c)
            want = {"persistent_tsit5_solve[tf32]": 1, "tsit5_step[tf32]": 1,
                    "tdmlp[tf32]": 4, "tsit5_step_bwd[tf32/tf32]": 1,
                    "persistent_stored_sweep[tf32/tf32]": 1}
        else:
            # the reference's default-tier gradients behind FP32 forwards
            want = {"persistent_tsit5_solve[fp32]": 1, "tsit5_step[fp32]": 1,
                    "tdmlp[fp32]": 4, "tsit5_step_bwd[fp32/tf32]": 1,
                    "persistent_stored_sweep[fp32/tf32]": 1}
        k = len(tb)
        check(all(c.get(n_, 0) == v * k for n_, v in want.items()),
              f"tf32 train {arm}: launches {c}, expected {want} a step")
    # each arm against the CPU at the card's tiers (8 images); 'auto'
    # against 'highest' take different steps by design (the tier's noise in
    # ũ), so their gradients differ by the solver's error at rtol 1e-4, not
    # by rounding: printed, and held on shared knots by [tf32 K7 bench]
    small = tuple(d[:8] for d in tb[0])
    for arm, (model, loss_fn, _, _, w_reg, _) in (("auto", tr_auto),
                                                 ("highest", tr_hi)):
        cpu = _train_setup(BENCH + (hi if arm == "highest" else []), "cpu",
                           {k: v.cpu() for k, v in sd.items()})
        with tiers_of(device):
            _, s_c, g_c = _grads(model, loss_fn, params0, small, 0.0)
            _, s_r, g_r = _grads(cpu[0], cpu[1],
                                 {k: v.cpu() for k, v in params0.items()},
                                 tuple(d.cpu() for d in small), 0.0)
        tiers = node_tiers(model, device)
        tol = grads_tol(tiers, node_tiers(cpu[0], device))
        ce_tol = cross_entropy_tol(tiers, node_tiers(cpu[0], device),
                                   s_r["y_pred"])
        rel = max(rel_err(g_c[k_].cpu(), g_r[k_]) for k_ in g_c)
        d_ce = abs(float(s_c["ce_loss"]) - float(s_r["ce_loss"]))
        print(f"[tf32 train bench {arm}] first step vs the CPU at the card's "
              f"tiers ({'/'.join(tiers)}), 8 images: NFE {int(s_c['nfe'])} vs "
              f"{int(s_r['nfe'])}, cross-entropy difference {d_ce:.3e} "
              f"(tolerance {ce_tol:.3e}), gradients relative max-abs "
              f"{rel:.3e} (tolerance {tol:.3e})")
        check(d_ce <= ce_tol and rel <= tol,
              f"tf32 train bench {arm}: disagrees with the CPU")
    (_, s_a, g_a), (_, s_h, g_h) = grads["auto"], grads["highest"]
    rel = max(rel_err(g_a[k_], g_h[k_]) for k_ in g_a)
    d_ce = abs(float(s_a["ce_loss"]) - float(s_h["ce_loss"]))
    print(f"[tf32 train bench] first step from one state: NFE auto "
          f"{int(s_a['nfe'])} vs highest {int(s_h['nfe'])}, loss "
          f"{float(s_a['ce_loss']):.6f} vs {float(s_h['ce_loss']):.6f} "
          f"(tolerance {CE_TOL:g}); gradients relative max-abs {rel:.3e} "
          f"(the solves' steps differ: held on shared knots by [tf32 K7 "
          f"bench])")
    check(d_ce <= CE_TOL, f"tf32 train bench: cross-entropy across tiers "
          f"{d_ce}")

    # --- mlp.yaml's train step: FP32 forward, TF32 gradient products,
    # against the card's FP32 plain route (across gradient tiers) and the
    # CPU at the card's tiers (8 images; the same tiers)
    tr = _train_setup([], device)
    sd = tr[0].state_dict()
    p0 = {k: v.detach().clone() for k, v in tr[3].params.items()}
    plain = _train_setup(["--model.use_pallas=off"], device, sd)
    _, s_p, g_p = _grads(plain[0], plain[1], p0, tb[0], 0.0)
    small = tuple(d[:8] for d in tb[0])
    g_arm = {}
    for gp in ("match", "default"):
        gp_o = [f"--model.solver.grad_precision={gp}"]
        model, loss_fn, step, ts, w_reg, sched = _train_setup(gp_o, device, sd)
        _, s_o, g_arm[gp] = _grads(model, loss_fn, p0, tb[0], 0.0)
        cpu = _train_setup(gp_o, "cpu", {k: v.cpu() for k, v in sd.items()})
        with tiers_of(device):
            _, s_s, g_s = _grads(model, loss_fn, p0, small, 0.0)
            _, s_c, g_c = _grads(cpu[0], cpu[1],
                                 {k: v.cpu() for k, v in p0.items()},
                                 tuple(d.cpu() for d in small), 0.0)
        warmup_model(step, None, ts, tb[0], w_reg(1), sched(1))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        ts, loss, stats = step(ts, tb[1], w_reg(2), sched(2))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        c = tier_counts()
        if gp == "match":
            add(c)
        tiers = node_tiers(model, device)
        x_tol = grads_tol(tiers, node_tiers(plain[0], device),
                          tf32_recompute=gp == "default")
        c_tol = grads_tol(tiers, node_tiers(cpu[0], device),
                          tf32_recompute=gp == "default")
        rel = max(rel_err(g_arm[gp][k_], g_p[k_]) for k_ in g_p)
        rel_c = max(rel_err(g_s[k_].cpu(), g_c[k_]) for k_ in g_c)
        d_ce = max(abs(float(s_o["ce_loss"]) - float(s_p["ce_loss"])),
                   abs(float(s_s["ce_loss"]) - float(s_c["ce_loss"])))
        ce_tol = cross_entropy_tol(tiers, node_tiers(cpu[0], device),
                                   s_c["y_pred"])
        print(f"[tf32 train mlp.yaml grad_precision={gp}] loss "
              f"{float(loss):.6f} NFE {int(stats['nfe'])} {ms:.3f} ms; "
              f"cross-entropy gradients vs the FP32 plain route (across "
              f"tiers) relative max-abs {rel:.3e} (tolerance {x_tol:.3e}), "
              f"NFE {int(s_o['nfe'])} vs {int(s_p['nfe'])}; vs the CPU at "
              f"the card's tiers ({'/'.join(tiers)}, 8 images) {rel_c:.3e} "
              f"(tolerance {c_tol:.3e}), NFE {int(s_s['nfe'])} vs "
              f"{int(s_c['nfe'])}; cross-entropy differences at most "
              f"{d_ce:.3e} (tolerance {ce_tol:.3e}) | launches "
              f"{ {k: v for k, v in c.items() if '[' in k} }")
        rec_t = "fp32" if gp == "match" else "tf32"
        want = {"persistent_tsit5_solve[fp32]": 1, "tsit5_step[fp32]": 1,
                "tdmlp[fp32]": 4, "tsit5_step_bwd[fp32/tf32]": 1,
                f"persistent_two_level_sweep[fp32/{rec_t}/tf32]": 1}
        check(all(c.get(n_, 0) == v for n_, v in want.items())
              and bool(stats["solver_success"]),
              f"tf32 train mlp.yaml {gp}: launches {c}, expected {want}")
        check(d_ce <= ce_tol and rel <= x_tol and rel_c <= c_tol,
              f"tf32 train mlp.yaml {gp}: gradients {rel} (FP32 plain), "
              f"{rel_c} (CPU)")
    rel = max(rel_err(g_arm["default"][k_], g_arm["match"][k_])
              for k_ in g_p)
    print(f"[tf32 train mlp.yaml] grad_precision default vs match: "
          f"cross-entropy gradients relative max-abs {rel:.3e}")
    for name, r in res.items():
        print(f"[tf32 kernel {name}] device ms a launch {r['ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    return res, counts


@contextlib.contextmanager
def cudnn_tf32():
    """cuDNN's own TF32 convolutions for the block only (the yardstick of
    ``[tf32 conv core]``: timed, never on a path of the port), the caller's
    flag restored after it."""
    import torch

    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = saved


def as_accurate(ours, plain, exact, floor):
    """Each of a TF32 kernel's outputs against the float64 result
    (``exact``), within twice its TF32 plain version's own distance from
    it, and never below ``floor`` (the kernel's truncated sums): both round
    the same operands, and TF32 rounds the activations again after each
    sum, so their sum orders part by TF32's rounding, not FP32's, and the
    tensor cores' sums round toward zero (a bias the plain version's sums
    lack); the kernel must be as accurate as the plain version. Returns
    (the worst output's share of its gate, its two distances)."""
    worst, by = 0.0, None
    for a, p, x in zip(ours, plain, exact):
        e, e_p = rel_err(a.double(), x), rel_err(p.double(), x)
        share = e / max(2 * e_p, floor)
        if by is None or share > worst:
            worst, by = share, (e, e_p)
    return worst, by


def phase_tf32_conv(device):
    """The conv family at the TF32 tier (``[tf32 conv ...]``, the
    reference's 'default', which cnn.yaml's 'auto' takes at rtol 1e-4):
    kernel 13 in its three modes and kernel 14 at both of its routes' tiers
    (TF32 throughout; FP32 recompute with TF32 gradients) as accurate as
    their TF32 plain versions against float64 (``as_accurate``) and
    against FP32 across tiers (``tf32_tol`` of the step's or the
    transposed step's depth), bitwise repeatable, their five digests and
    device times beside the FP32 instantiations; the conv core's
    orientations at TF32 against cuDNN FP32 on rounded operands, timed
    beside the FFMA core and cuDNN's own TF32; then cnn.yaml's serving batch
    and a ``none`` and an ``unbiased`` train step through 'auto' (TF32) and
    'highest' (FP32 forward, TF32 gradients) in one call, each against the
    CPU at the card's tiers, with launches by tier (counted from zero
    before each, read after it). Returns (the kernels line's TF32 rows, the
    paths' launch counts with tiers)."""
    import torch
    from torch.nn.grad import conv2d_input, conv2d_weight

    from localregneuralde_tpu_torch.harness import warmup_model
    from localregneuralde_tpu_torch.nn import round_tf32
    from localregneuralde_tpu_torch.ops.cuda import (
        _build, conv_step_plain, fused_conv_step, fused_conv_step_bwd,
        fused_conv_step_bwd_plain, reset_launch_counts,
    )

    res = {}
    w, spec, u, k1, rstats, t, dt = _conv_inputs(device)
    B_, H_, W_, Cs = u.shape
    Ch = spec.Ch
    w64, u64, k1_64, t64, dt64 = (type(w)(*(p.double() for p in w)),
                                  u.double(), k1.double(), t.double(),
                                  dt.double())
    rs64 = tuple(r.double() for r in rstats)
    k_conv = 9 * (Ch + 1)  # a conv's longest K
    step_floor = tf32_sum_tol(CONV_STEP_PRODUCTS, k_conv)

    # kernel 13 in its three modes
    lib = _build.load_library()
    sc = torch.stack([t, dt])
    for mode in ("train", "running", "batch"):
        sp = spec._replace(eval_stats="batch") if mode == "batch" else spec
        training = mode == "train"
        kw = dict(training=training, rstats=rstats)
        with torch.no_grad():
            out = fused_conv_step(w, sp, u, t, dt, k1, **kw, precision=None)
            again = fused_conv_step(w, sp, u, t, dt, k1, **kw,
                                    precision=None)
            fp = fused_conv_step(w, sp, u, t, dt, k1, **kw)
            ref = conv_step_plain(w, sp, u, t, dt, k1, **kw, tier="tf32")
            exact = conv_step_plain(w64, sp, u64, t64, dt64, k1_64,
                                    training=training, rstats=rs64)
        pick = lambda o: [o[0], *o[2:9], *(o[9] or ())]  # noqa: E731
        worst, (e, e_p) = as_accurate(pick(out), pick(ref), pick(exact),
                                      step_floor)
        ut_ok = utilde_ok(out[1], ref[1], out[2:8], ref[2:8], dt)
        xt = max(rel_err(a, b) for a, b in zip(pick(out), pick(fp)))
        ut_xt = utilde_ok(out[1], fp[1], out[2:8], fp[2:8], dt)
        bitwise = all(torch.equal(a, b) for a, b in zip(out[:9], again[:9]))
        digest({"train": "K13 train tf32", "running": "K13 eval tf32",
                "batch": "K13 eval batch tf32"}[mode], *out[:9],
               *(out[9] if training else ()))
        print(f"[tf32 conv step {mode}] vs float64 relative max-abs "
              f"{e:.3e}, the TF32 plain version's {e_p:.3e}: at most "
              f"{worst:.3f} of the gate (twice the plain's, at least "
              f"{step_floor:.3e}); ũ vs the TF32 plain within dt·max|Δk| "
              f"{ut_ok}; "
              f"bitwise repeatable {bitwise}; vs FP32 (across tiers) "
              f"{xt:.3e}, tolerance {tf32_tol(CONV_STEP_PRODUCTS):.3e}, ũ "
              f"within dt·max|Δk| {ut_xt}")
        check(worst <= 1 and ut_ok and bitwise,
              f"conv step tf32 {mode} disagrees with its plain version")
        check(xt <= tf32_tol(CONV_STEP_PRODUCTS) and ut_xt,
              f"conv step tf32 {mode} vs fp32: {xt}")
        if training:
            err13 = max(max_abs(a, b) for a, b in zip(out[:9], ref[:9]))
    outs = [torch.empty_like(u) for _ in range(9)]
    rs = torch.stack(rstats).contiguous()
    scr13 = torch.empty(lib.lrnde_conv_step_scratch_floats(B_, H_, W_, Cs, Ch),
                        device=device)

    def raw13(entry, mode):
        return raw_launch(entry, u, k1, sc, *w, *outs, rs,
                          torch.empty_like(rs) if mode == 0 else None, scr13,
                          mode, spec.momentum, 1.0 - spec.momentum, spec.eps,
                          B_, H_, W_, Cs, Ch)

    raws = [raw13(e, m) for m in (0, 1)
            for e in ("lrnde_conv_step_tf32", "lrnde_conv_step")]
    check(all(r() == 0 for r in raws), "conv step tf32: raw launch failed")
    ms_t, ms_f, ms_te, ms_fe = back_to_back_ms(raws, n=20, warmup=3)
    with torch.no_grad():
        plain13, = median_ms([lambda: conv_step_plain(
            w, spec, u, t, dt, k1, training=True, rstats=rstats,
            tier="tf32")], n=10, warmup=2)
    print(f"[tf32 conv attribution] kernel 13 back to back: train TF32 "
          f"{ms_t:.4f} ms (FP32 {ms_f:.4f}), eval (running stats) TF32 "
          f"{ms_te:.4f} (FP32 {ms_fe:.4f})")
    sequence_split("tf32 conv attribution train", raws[0], conv_role, ms_t)
    f13 = 6 * conv_flops(B_, H_, W_, Cs, Ch)
    n_w = sum(p.numel() for p in w)
    n_u = u.numel()
    res["fused_conv_step_tf32"] = dict(
        max_abs_err=err13, ms=ms_t, plain_ms=plain13,
        **bound(f13, 4 * (11 * n_u + n_w), PEAK_TF32))

    # kernel 14 at cnn.yaml's route (TF32 recompute and gradients) and at
    # 'highest''s (FP32 recompute, TF32 gradients)
    g = torch.Generator(device=device).manual_seed(17)
    cts = [torch.randn(u.shape, generator=g, device=device) for _ in range(9)]
    fp = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts)
    exact = fused_conv_step_bwd_plain(w64, spec, u64, t64, dt64, k1_64,
                                      [c.double() for c in cts])

    def flat(o):
        return [o[1], o[2], *o[0]]

    grads = [torch.empty_like(p) for p in (u, u, *w)]
    scr14 = torch.empty(
        lib.lrnde_conv_step_bwd_scratch_floats(B_, H_, W_, Cs, Ch),
        device=device)
    for label, prec, tiers in (("tf32", None, ("tf32", "tf32")),
                               ("tf32grads", "highest", ("fp32", "tf32"))):
        depth = CONV_GRAD_PRODUCTS + (CONV_STEP_PRODUCTS
                                      if tiers[0] == "tf32" else 0)
        ours = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts,
                                   precision=prec, grad_precision=None)
        again = fused_conv_step_bwd(w, spec, u, t, dt, k1, cts,
                                    precision=prec, grad_precision=None)
        ref = fused_conv_step_bwd_plain(w, spec, u, t, dt, k1, cts, *tiers)
        floor = tf32_sum_tol(depth, k_conv)
        worst, (e, e_p) = as_accurate(flat(ours), flat(ref), flat(exact),
                                      floor)
        xt = max(rel_err(a, b) for a, b in zip(flat(ours), flat(fp)))
        same = all(torch.equal(a, b) for a, b in zip(flat(again),
                                                     flat(ours)))
        print(f"[tf32 conv step_bwd {'/'.join(tiers)}] (recompute/gradients) "
              f"vs float64 relative max-abs {e:.3e}, the TF32 plain "
              f"version's {e_p:.3e}: at most {worst:.3f} of the gate (at "
              f"least {floor:.3e}); bitwise "
              f"repeatable {same}; vs FP32 (across tiers) {xt:.3e}, "
              f"tolerance {tf32_tol(depth):.3e}")
        check(worst <= 1 and same, f"conv step_bwd {label} vs plain")
        check(xt <= tf32_tol(depth), f"conv step_bwd {label} vs fp32: {xt}")
        digest("K14 tf32" if label == "tf32" else "K14 grads tf32",
               *flat(ours))
        bits = 3 if label == "tf32" else 2
        raw = raw_launch("lrnde_conv_step_bwd", bits, u, k1, sc, *w,
                         *cts, *grads, scr14, spec.eps, B_, H_, W_, Cs, Ch)
        raw_fp = raw_launch("lrnde_conv_step_bwd", 0, u, k1, sc, *w,
                            *cts, *grads, scr14, spec.eps, B_, H_, W_, Cs,
                            Ch)
        check(raw() == 0 and raw_fp() == 0, f"step_bwd {label}: raw launch")
        ms, ms_fp = back_to_back_ms([raw, raw_fp], n=20, warmup=3)
        plain, = median_ms([lambda: fused_conv_step_bwd_plain(
            w, spec, u, t, dt, k1, cts, *tiers)], n=5, warmup=1)
        print(f"[tf32 conv attribution] kernel 14 {'/'.join(tiers)} back to "
              f"back {ms:.4f} ms (FP32 {ms_fp:.4f})")
        err = max(max_abs(a, b) for a, b in zip(flat(ours), flat(ref)))
        n_b = 4 * (13 * n_u + 2 * n_w)
        res[f"fused_conv_step_bwd_{label}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain,
            **(bound(3 * f13, n_b, PEAK_TF32) if label == "tf32"
               else mixed_bound(f13, 2 * f13, n_b)))

    # the conv core's orientations at TF32 (cnn.yaml's widths, B = 32, 32x32)
    b, h, w_ = 32, 32, 32
    M = b * h * w_
    gen = torch.Generator().manual_seed(3)
    nchw = lambda x_: x_.permute(0, 3, 1, 2)  # noqa: E731
    sc0 = torch.tensor([0.37, 0.0], device=device)
    rows = []
    for name, orient, cin, cout in (("forward N=64", 0, 64, 64),
                                    ("forward N=64 + BN statistics", 5, 64,
                                     64),
                                    ("forward N=8", 0, 64, 8),
                                    ("data grad N=64", 1, 64, 64),
                                    ("data grad N=8", 1, 64, 8),
                                    ("weight grad N=64", 2, 64, 64),
                                    ("weight grad N=8", 2, 64, 8)):
        x = torch.randn(b, h, w_, cin, generator=gen).to(device)
        if orient in (0, 5):
            wt = (0.05 * torch.randn(3, 3, cin, cout, generator=gen)).to(device)

            def conv(a_, b2):
                return torch.nn.functional.conv2d(
                    nchw(a_), b2.permute(3, 2, 0, 1), padding=1)

            ops, k, out = (x, wt), 9 * cin, torch.empty(b, h, w_, cout,
                                                        device=device)
        elif orient == 1:
            wt = (0.05 * torch.randn(3, 3, cout + 1, cin, generator=gen)).to(
                device)

            def conv(a_, b2):
                return conv2d_input((b, cout, h, w_), b2[:, :, :cout].permute(
                    3, 2, 0, 1).contiguous(), nchw(a_), padding=1)

            ops, k, out = (x, wt), 9 * cin, torch.empty(b, h, w_, cout,
                                                        device=device)
        else:
            dy = torch.randn(b, h, w_, cout, generator=gen).to(device)
            s_ = torch.full((b, h, w_, 1), 0.37, device=device)

            def conv(a_, d_):
                return conv2d_weight(nchw(torch.cat([a_, s_], dim=-1)),
                                     (cout, cin + 1, 3, 3), nchw(d_),
                                     padding=1)

            ops, k, out = (x, dy), M, torch.empty(3, 3, cin + 1, cout,
                                                  device=device)
        perm = (2, 3, 1, 0) if orient == 2 else (0, 2, 3, 1)
        with torch.no_grad():
            ref = conv(*(round_tf32(o) for o in ops)).permute(*perm)
            mag = conv(*(round_tf32(o).abs() for o in ops)).permute(*perm)
        scratch = torch.empty(
            lib.lrnde_conv_core_scratch_floats(orient, b, h, w_, cin, cout),
            device=device)
        raw = raw_launch("lrnde_conv_core", orient, 1, *ops, sc0, out,
                         scratch, b, h, w_, cin, cout)
        raw_fp = raw_launch("lrnde_conv_core", orient, 0, *ops, sc0,
                            torch.empty_like(out), scratch, b, h, w_, cin,
                            cout)
        check(raw() == 0 and raw_fp() == 0, f"tf32 conv core {name}: launch")
        ok = bool(((out - ref).abs() <= 2 * k * 2.0 ** -24 * mag
                   + 1e-30).all())
        err = max_abs(out, ref)
        first = out.clone()
        check(ok and raw() == 0 and torch.equal(out, first),
              f"tf32 conv core {name}: vs cuDNN on rounded operands {err}, "
              f"or not bitwise repeatable")
        if orient == 5:
            z = out.reshape(-1, cout).double()
            mean, var = z.mean(0), z.var(0, unbiased=False)
            st_ = scratch[:2 * cout].double()
            s_err = max(float(((st_[:cout] - mean).abs() / var.sqrt()).max()),
                        float(((st_[cout:] - var).abs() / var).max()))
            check(s_err <= 1e-5, f"tf32 conv core {name}: statistics {s_err}")
        halo = ""
        if cout <= 8 and orient < 2:
            gather = raw_launch("lrnde_conv_core", orient + 3, 1, *ops, sc0,
                                out, scratch, b, h, w_, cin, cout)
            check(gather() == 0 and torch.equal(out, first),
                  f"tf32 conv core {name}: halo tile vs gather tile")
            halo = ", bitwise the gather tile"
        lib_fn = lambda: conv(*ops)  # noqa: E731

        def lib_tf32():
            with cudnn_tf32():
                return conv(*ops)

        with torch.no_grad():
            ms, ms_fp, lib_ms, lib_tf = back_to_back_ms(
                [raw, raw_fp, lib_fn, lib_tf32], n=50, warmup=5)
        flops = 2 * M * 9 * (cin + (orient == 2)) * cout
        row = dict(name=name, ms=ms, ffma_ms=ms_fp, cudnn_fp32_ms=lib_ms,
                   cudnn_tf32_ms=lib_tf, tflops=flops / ms / 1e9,
                   max_abs_err=err)
        print(f"[tf32 conv core] {name}: TF32 {1e3 * ms:.2f} µs "
              f"({row['tflops']:.2f} TFLOP/s), FFMA {1e3 * ms_fp:.2f} | "
              f"cuDNN FP32 {1e3 * lib_ms:.2f}, cuDNN TF32 {1e3 * lib_tf:.2f} "
              f"µs | max-abs {err:.2e} vs cuDNN FP32 on rounded operands "
              f"(within 2·K·2^-24 of the products' magnitudes), bitwise "
              f"repeatable{halo}")
        rows.append(row)
    print(json.dumps({"conv_core_tf32": rows}))

    # --- cnn.yaml: 'auto' (TF32) and 'highest' (FP32 forward, TF32
    # gradients), serving and training, each against the CPU at the card's
    # tiers
    hi = ["--model.solver.precision=highest"]
    counts = {}

    def add(c):
        for k_, v in c.items():
            counts[k_] = counts.get(k_, 0) + v

    test = _cifar_batches(device, "test", 1)[0]
    data = _cifar_batches(device, "train", 2)
    s_auto = _cifar_setup(device)
    sd = {k_: v.detach().clone() for k_, v in s_auto["model"].state_dict()
          .items()}
    cpu_sd = {k_: v.cpu() for k_, v in sd.items()}
    arms = {"auto": (s_auto, []), "highest": (_cifar_setup(device, hi, sd),
                                               hi)}
    served = {}
    for arm, (st_, ov) in arms.items():
        st_["eval"](st_["ts"], test, st_["w_reg"](1))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, stats = st_["eval"](st_["ts"], test, st_["w_reg"](1))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        c = tier_counts()
        add(c)
        tiers = node_tiers(st_["model"], device)
        nfe = int(stats["nfe"])
        cpu = _cifar_setup("cpu", ov, cpu_sd)
        small = tuple(d[:4] for d in test)
        _, on_card = st_["eval"](st_["ts"], small, st_["w_reg"](1))
        with tiers_of(device):
            _, on_host = cpu["eval"](cpu["ts"],
                                     tuple(d.cpu() for d in small),
                                     cpu["w_reg"](1))
        err = rel_err(on_card["y_pred"].cpu(), on_host["y_pred"])
        tol, _ = logits_tol(tiers, node_tiers(cpu["model"], device),
                            **CONV_DEPTHS)
        served[arm] = stats
        print(f"[tf32 conv serve {arm}] ({'/'.join(tiers)}) loss "
              f"{float(loss):.6f} NFE {nfe} success "
              f"{bool(stats['solver_success'])} {ms:.3f} ms; 4 images vs the "
              f"CPU at the card's tiers: logits relative max-abs {err:.3e} "
              f"(tolerance {tol:.3e}), NFE {int(on_card['nfe'])} vs "
              f"{int(on_host['nfe'])} | launches "
              f"{ {k_: v for k_, v in c.items() if '[' in k_} }")
        check(bool(stats["solver_success"]) and bool(torch.isfinite(loss))
              and {k_: v for k_, v in c.items() if v} == {
                  "fused_conv_step": (nfe - 2) // 6,
                  f"fused_conv_step[{tiers[0]}]": (nfe - 2) // 6}
              and err <= tol, f"tf32 conv serve {arm}: launches {c} or the "
              f"CPU {err}")
    rel = rel_err(served["auto"]["y_pred"], served["highest"]["y_pred"])
    tol, _ = logits_tol(("tf32",), ("fp32",), **CONV_DEPTHS)
    print(f"[tf32 conv serve] NFE auto {int(served['auto']['nfe'])} vs "
          f"highest {int(served['highest']['nfe'])}; logits relative max-abs "
          f"{rel:.3e} (across tiers, tolerance {tol:.3e})")
    check(rel <= tol, f"tf32 conv serve: logits across tiers {rel}")

    params0 = {k_: v.detach().clone() for k_, v in s_auto["ts"].params.items()}
    cpu_p0 = {k_: v.cpu() for k_, v in params0.items()}
    for reg in ("none", "unbiased"):
        first = {}
        for arm, (_, ov) in arms.items():
            st_ = _cifar_setup(device, ov, sd, reg)
            loss, _, stats, grads = _cifar_forward(
                st_, params0, st_["model"].init_state(), data[0], 0.0)
            first[arm] = (stats, grads)
            warmup_model(st_["train"], None, st_["ts"], data[0],
                         st_["w_reg"](1), st_["sched"](1))
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            ts, tl, tstats = st_["train"](st_["ts"], data[1], st_["w_reg"](2),
                                          st_["sched"](2))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            c = tier_counts()
            add(c)
            tiers = node_tiers(st_["model"], device)
            want = {f"fused_conv_step[{tiers[0]}]",
                    f"fused_conv_step_bwd[{tiers[0]}/tf32]"}
            # 2 images against the CPU at the card's tiers
            cpu = _cifar_setup("cpu", ov, cpu_sd, reg)
            small = tuple(d[:2] for d in data[0])
            with tiers_of(device):
                _, _, s_c, g_c = _cifar_forward(
                    st_, params0, st_["model"].init_state(), small, 0.0)
                _, _, s_r, g_r = _cifar_forward(
                    cpu, cpu_p0, cpu["model"].init_state(),
                    tuple(d.cpu() for d in small), 0.0)
            g_tol = grads_tol(tiers, node_tiers(cpu["model"], device),
                              **CONV_DEPTHS)
            rel_c = (max(max_abs(g_c[k_].cpu(), g_r[k_]) for k_ in g_r)
                     / max(float(v.abs().max()) for v in g_r.values()))
            d_ce = abs(float(s_c["ce_loss"]) - float(s_r["ce_loss"]))
            c_tol = cross_entropy_tol(tiers, tiers, s_r["y_pred"],
                                      **CONV_DEPTHS)
            print(f"[tf32 conv train {reg} {arm}] ({'/'.join(tiers)}) loss "
                  f"{float(tl):.6f} NFE {int(tstats['nfe'])} success "
                  f"{bool(tstats['solver_success'])} {ms:.3f} ms a step; "
                  f"first step vs the CPU at the card's tiers (2 images): "
                  f"NFE {int(s_c['nfe'])} vs {int(s_r['nfe'])}, cross-entropy "
                  f"difference {d_ce:.3e} (tolerance {c_tol:.3e}), gradients "
                  f"relative max-abs {rel_c:.3e} (tolerance {g_tol:.3e}) | "
                  f"launches {({k_: v for k_, v in c.items() if '[' in k_})}")
            check(bool(tstats["solver_success"]) and bool(torch.isfinite(tl))
                  and {k_ for k_, v in c.items() if '[' in k_ and v} == want
                  and d_ce <= c_tol and rel_c <= g_tol,
                  f"tf32 conv train {reg} {arm}: launches {c}, expected "
                  f"{want}; or the CPU: {d_ce}, {rel_c}")
        (s_a, g_a), (s_h, g_h) = first["auto"], first["highest"]
        rel = (max(max_abs(g_a[k_], g_h[k_]) for k_ in g_a)
               / max(float(v.abs().max()) for v in g_h.values()))
        d_ce = abs(float(s_a["ce_loss"]) - float(s_h["ce_loss"]))
        c_tol = cross_entropy_tol(("tf32",), ("fp32",), s_h["y_pred"],
                                  **CONV_DEPTHS)
        print(f"[tf32 conv train {reg}] first step from one state (32 "
              f"images): NFE auto {int(s_a['nfe'])} vs highest "
              f"{int(s_h['nfe'])}, cross-entropy {float(s_a['ce_loss']):.6f} "
              f"vs {float(s_h['ce_loss']):.6f} (across tiers, tolerance "
              f"{c_tol:.3e}); gradients relative max-abs {rel:.3e} (the "
              f"solves' steps differ with the tier's noise in ũ)")
        check(d_ce <= c_tol, f"tf32 conv train {reg}: cross-entropy across "
              f"tiers {d_ce}")
    for name, r in res.items():
        print(f"[tf32 kernel {name}] device ms a launch {r['ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    return res, counts


def phase_tf32_sde(device):
    """The SDE family at the TF32 tier (``[tf32 sde ...]``, the reference's
    'default', which mnist_sde's 'auto' takes at rtol 0.14): kernel 10 at
    TF32 against its TF32 plain version on the same Philox path (step
    counts, states, and each recorded step as accurate against its float64
    step as the TF32 plain step, ``as_accurate``), bitwise repeatable;
    kernel 12 at both of its routes' tiers (TF32 throughout; FP32
    recompute with TF32 gradients) on kernel 10's TF32 knots, as accurate
    against the float64 plain sweep as its TF32 plain version and within
    one swept step's TF32 rounding of FP32, bitwise repeatable; the five
    digests; device times beside the FP32 instantiations in the same call;
    then mnist_sde's serving batch and an ``unbiased`` train step through
    'auto' (TF32) and 'highest' (FP32 forwards, TF32 gradients), each
    against the CPU at the card's tiers, with launches by tier (counted
    from zero before each, read after it). Returns (the kernels line's TF32
    rows, the paths' launch counts with tiers)."""
    import torch

    from localregneuralde_tpu_torch.harness import (
        make_eval_step, warmup_model,
    )
    from localregneuralde_tpu_torch.ops.cuda import (
        SDEWeights, persistent_sde_solve, persistent_sde_solve_plain,
        persistent_sde_sweep, persistent_sde_sweep_plain, reset_launch_counts,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_sde_solve import (
        diffusion_plain, drift_plain,
    )
    from localregneuralde_tpu_torch.sde import (
        PhiloxNormals, get_sri_tableau, sri_step,
    )

    res = {}
    model, _, _, _ = _sde_model(device)
    node = model.neural_dsde
    w = SDEWeights(*(p.detach() for p in list(node.drift.parameters())
                     + list(node.diffusion.parameters())))
    w64 = SDEWeights(*(p.double() for p in w))
    u0 = _sde_input(model, _mnist_batches(device, 1)[0][0])
    Fs, Hs = u0.shape[1], w.b1.shape[0]
    saveat = torch.tensor([0.5, 1.0], device=device)
    kw = dict(noise=PhiloxNormals(1234, B, Fs, device=device), rtol=SDE_TOL,
              atol=SDE_TOL, solver="sosri", delta=1 / 6, saveat_arr=saveat,
              max_steps=10000, record_knots=True)
    mlp_sde = 2 * B * (2 * Fs * Hs + Fs * Fs)
    n_w = 2 * Fs * Hs + Hs + Fs * Fs + 2 * Fs

    # kernel 10 at TF32 against its TF32 plain version on the same path
    out = persistent_sde_solve(w, u0, (0.0, 1.0), precision=None, **kw)
    again = persistent_sde_solve(w, u0, (0.0, 1.0), precision=None, **kw)
    fp = persistent_sde_solve(w, u0, (0.0, 1.0), **kw)
    ref = persistent_sde_solve_plain(w, u0, (0.0, 1.0), tier="tf32", **kw)
    digest("K10 tf32", out)
    na, ta = int(out["naccept"]), int(out["natt"])
    nb, tb = int(ref["naccept"]), int(ref["natt"])
    n = na
    bitwise = (int(again["natt"]) == ta
               and torch.equal(again["ys"], out["ys"])
               and torch.equal(again["knot_us"][:n + 1],
                               out["knot_us"][:n + 1]))
    err = max_abs(out["ys"], ref["ys"])
    scale = float(ref["ys"].abs().max())
    # the same steps on the same path: the states part by one evaluation's
    # TF32 rounding of their scale (and the path's ulp-level step times,
    # tests/test_torch_sde_precision.py)
    s_tol = 2e-3 + tf32_tol(EVAL_PRODUCTS) * scale
    # each recorded step from the kernel's own knot, as accurate against
    # its float64 step as the TF32 plain step (the increments u_new − u)
    tab = get_sri_tableau("sosri")
    ts_ = out["knot_ts"][: n + 1]
    inc_k, inc_p, inc_x = [], [], []
    for j in range(n):
        u, dt = out["knot_us"][j], ts_[j + 1] - ts_[j]
        dw_, dz_ = out["knot_dws"][j], out["knot_dzs"][j]
        st = sri_step(lambda v, t: drift_plain(w, v, "tf32"),
                      lambda v, t: diffusion_plain(w, v, "tf32"), u, ts_[j],
                      dt, dw_, dz_, SDE_TOL, SDE_TOL, 1 / 6, tab)
        st64 = sri_step(lambda v, t: drift_plain(w64, v),
                        lambda v, t: diffusion_plain(w64, v), u.double(),
                        ts_[j].double(), dt.double(), dw_.double(),
                        dz_.double(), SDE_TOL, SDE_TOL, 1 / 6, tab)
        inc_k.append(out["knot_us"][j + 1] - u)
        inc_p.append(st.u_new - u)
        inc_x.append(st64.u_new - u.double())
    floor = tf32_sum_tol(4 * EVAL_PRODUCTS, Hs)
    worst, (e, e_p) = as_accurate([torch.stack(inc_k)], [torch.stack(inc_p)],
                                  [torch.stack(inc_x)], floor)
    yf_x = max_abs(out["y_final"], fp["y_final"])
    print(f"[tf32 sde solve] kernel {na} accepts / {ta} attempts, TF32 plain "
          f"{nb} / {tb}, FP32 kernel {int(fp['naccept'])} / "
          f"{int(fp['natt'])}; ys vs the TF32 plain max-abs {err:.3e} "
          f"(tolerance {s_tol:.3e} on the same steps); its {n} steps vs "
          f"float64 relative max-abs {e:.3e}, the TF32 plain steps' "
          f"{e_p:.3e}: at most {worst:.3f} of the gate (twice the plain's, "
          f"at least {floor:.3e}); bitwise repeatable {bitwise}; y_final vs "
          f"FP32 (across tiers: the steps' times part by TF32's noise in "
          f"ũ, so the path is sampled elsewhere) max-abs {yf_x:.3e}")
    check(bool(out["success"]) and bool(ref["success"]) and bitwise,
          "tf32 sde solve: not successful or not repeatable")
    check(abs(ta - tb) <= 2 and (err <= s_tol if ta == tb
                                 else max_abs(out["y_final"],
                                              ref["y_final"]) <= 5e-2),
          f"tf32 sde solve vs its plain version: {ta}/{tb} attempts, ys "
          f"max-abs {err}")
    check(worst <= 1, f"tf32 sde solve: steps vs float64 {e} (plain {e_p})")
    args_t, bar_t, out_t = _sde_raw_args(w, u0, kw, "tf32")
    args_f, bar_f, _ = _sde_raw_args(w, u0, kw)
    raw_t = raw_launch("lrnde_sde_solve_tf32", *args_t)
    raw_f = raw_launch("lrnde_sde_solve", *args_f)
    check((bar_t.zero_(), raw_t())[1] == 0
          and torch.equal(out_t["ys"], out["ys"])
          and torch.equal(out_t["y_final"], out["y_final"]),
          "tf32 sde solve: the raw launch differs from the wrapper's")
    ms_t, ms_f = back_to_back_ms([lambda: (bar_t.zero_(), raw_t())[1],
                                  lambda: (bar_f.zero_(), raw_f())[1]],
                                 n=20, warmup=2)
    plain, = median_ms([lambda: persistent_sde_solve_plain(
        w, u0, (0.0, 1.0), tier="tf32", **kw)], n=3, warmup=1)
    print(f"[tf32 sde attribution] kernel 10 back to back: TF32 {ms_t:.4f} "
          f"ms ({1e3 * ms_t / ta:.2f} µs an attempt), FP32 {ms_f:.4f} "
          f"({1e3 * ms_f / int(fp['natt']):.2f} µs an attempt)")
    nbytes = 4 * ((1 + 3 + 3 * n + 1) * B * Fs + n_w)
    res["persistent_sde_solve_tf32"] = dict(
        max_abs_err=err, ms=ms_t, plain_ms=plain,
        **tree_bound(ta * 25 * B * (-(-Fs // 2)), 4 * ta * mlp_sde, nbytes,
                     PEAK_TF32))

    # kernel 12 at both of its routes' tiers, on kernel 10's TF32 knots
    g = torch.Generator(device=device).manual_seed(11)
    args = (out["knot_ts"], out["knot_us"], out["knot_dws"],
            out["knot_dzs"], out["naccept"], saveat,
            torch.randn((2, B, Fs), generator=g, device=device),
            torch.randn((B, Fs), generator=g, device=device))
    args64 = tuple(a_.double() if a_.is_floating_point() else a_
                   for a_ in args)
    sw = dict(solver="sosri", delta=1 / 6)
    flat = lambda o: [o[0], *o[1]]  # noqa: E731
    exact = flat(persistent_sde_sweep_plain(w64, *args64, **sw))
    fp32 = flat(persistent_sde_sweep(w, *args, **sw))
    raw, a_u, d_w = _sde_sweep_raw(w, args, device)
    for label, prec, tiers in (("tf32", None, ("tf32", "tf32")),
                               ("tf32grads", "highest", ("fp32", "tf32"))):
        depth = (SDE_STEP_BWD_PRODUCTS if tiers[0] == "tf32"
                 else SDE_GRAD_PRODUCTS)
        ours = flat(persistent_sde_sweep(w, *args, **sw, precision=prec,
                                         grad_precision=None))
        again = flat(persistent_sde_sweep(w, *args, **sw, precision=prec,
                                          grad_precision=None))
        plain_s = flat(persistent_sde_sweep_plain(
            w, *args, **sw, tier=tiers[0], grad_tier=tiers[1]))
        tag = "tf32" if label == "tf32" else "tf32g"
        digest(f"K12 state {tag}", ours[0])
        digest(f"K12 grads {tag}", *ours[1:])
        floor = tf32_sum_tol(depth, Hs)
        worst, (e, e_p) = as_accurate(ours, plain_s, exact, floor)
        xt = max(rel_err(a_, b_) for a_, b_ in zip(ours, fp32))
        same = all(torch.equal(a_, b_) for a_, b_ in zip(ours, again))
        print(f"[tf32 sde sweep {'/'.join(tiers)}] (recompute/gradients) "
              f"{n} steps: vs float64 relative max-abs {e:.3e}, the TF32 "
              f"plain version's {e_p:.3e}: at most {worst:.3f} of the gate "
              f"(at least {floor:.3e}); bitwise repeatable {same}; vs FP32 "
              f"(across tiers) {xt:.3e}, tolerance {tf32_tol(depth):.3e}")
        check(worst <= 1 and same, f"tf32 sde sweep {label} vs plain")
        check(xt <= tf32_tol(depth), f"tf32 sde sweep {label} vs fp32: {xt}")
        bits = 3 if label == "tf32" else 2
        r_t = raw_launch("lrnde_sde_sweep", bits, *raw)
        r_f = raw_launch("lrnde_sde_sweep", 0, *raw)
        check(r_t() == 0 and torch.equal(a_u, ours[0]) and torch.equal(
            d_w, torch.cat([g_.reshape(-1) for g_ in ours[1:]])) and
            r_f() == 0, f"tf32 sde sweep {label}: the raw launch differs")
        ms, ms_fp = back_to_back_ms([r_t, r_f], n=20, warmup=3)
        plain, = median_ms([lambda: persistent_sde_sweep_plain(
            w, *args, **sw, tier=tiers[0], grad_tier=tiers[1])], n=3,
            warmup=1)
        print(f"[tf32 sde attribution] kernel 12 {'/'.join(tiers)} back to "
              f"back {ms:.4f} ms ({ms / n:.4f} a step), FP32 {ms_fp:.4f}")
        err = max(max_abs(a_, b_) for a_, b_ in zip(ours, plain_s))
        n_b = 4 * ((3 * n + 1 + 3 + 1) * B * Fs + 2 * n_w)
        res[f"persistent_sde_sweep_{label}"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain,
            **(bound(12 * n * mlp_sde, n_b, PEAK_TF32) if label == "tf32"
               else mixed_bound(4 * n * mlp_sde, 8 * n * mlp_sde, n_b)))

    # --- mnist_sde: 'auto' (TF32) and 'highest' (FP32 forwards, TF32
    # gradients), serving and training, each against the CPU at the card's
    # tiers
    hi = ["--model.solver.precision=highest"]
    counts = {}

    def add(c):
        for k_, v in c.items():
            counts[k_] = counts.get(k_, 0) + v

    test = _mnist_batches(device, 1)[0]
    data = _mnist_batches(device, 2, train=True)
    sd = {k_: v.detach().clone() for k_, v in model.state_dict().items()}
    cpu_sd = {k_: v.cpu() for k_, v in sd.items()}
    first = {}
    for arm, ov in (("auto", []), ("highest", hi)):
        m_, loss_fn, ts, w_reg = _sde_model(device, ov, sd)
        tiers = node_tiers(m_, device)
        step = make_eval_step(m_, loss_fn)
        step(ts, test, w_reg(1))
        torch.cuda.synchronize()
        ts = _fresh(ts, m_)
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, stats = step(ts, test, w_reg(1))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        c = tier_counts()
        add(c)
        cpu = _sde_model("cpu", ov, cpu_sd)
        small = tuple(d[:8] for d in test)
        on_card = step(_fresh(ts, m_), small, w_reg(1))[1]
        with tiers_of(device):
            on_host = make_eval_step(cpu[0], cpu[1])(
                cpu[2], tuple(d.cpu() for d in small), w_reg(1))[1]
        same_path = int(on_card["nfe"][0]) == int(on_host["nfe"][0])
        tol, _ = logits_tol(tiers, node_tiers(cpu[0], device), **SDE_DEPTHS)
        err = rel_err(on_card["y_pred"].cpu(), on_host["y_pred"])
        err_abs = max_abs(on_card["y_pred"].cpu(), on_host["y_pred"])
        print(f"[tf32 sde serve {arm}] ({'/'.join(tiers)}) loss "
              f"{float(loss):.6f} NFE {int(stats['nfe'][0])} success "
              f"{bool(stats['solver_success'])} {ms:.3f} ms; 8 images vs the "
              f"CPU at the card's tiers: logits relative max-abs {err:.3e} "
              f"(tolerance {tol:.3e} on the same steps, else 5e-2 max-abs: "
              f"{err_abs:.3e}), NFE {int(on_card['nfe'][0])} vs "
              f"{int(on_host['nfe'][0])} | launches "
              f"{ {k_: v for k_, v in c.items() if '[' in k_ and v} }")
        check(bool(stats["solver_success"]) and bool(torch.isfinite(loss))
              and {k_: v for k_, v in c.items() if v} == {
                  "persistent_sde_solve": 1,
                  f"persistent_sde_solve[{tiers[0]}]": 1}
              and (err <= tol if same_path else err_abs <= 5e-2),
              f"tf32 sde serve {arm}: launches {c} or the CPU {err}")
        # an unbiased train step, and the first step from one state against
        # the CPU at the card's tiers (8 images)
        tm, tl_fn, tstep, tts, tw_reg, sched = _train_setup(
            ov, device, sd, regularize="unbiased", config=SDE_CONFIG)
        params0 = {k_: v.detach().clone() for k_, v in tts.params.items()}
        warmup_model(tstep, None, tts, data[0], tw_reg(1), sched(1))
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        tts, tl, tstats = tstep(tts, data[1], tw_reg(2), sched(2))
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        c = tier_counts()
        add(c)
        want = {f"persistent_sde_solve[{tiers[0]}]",
                f"persistent_sde_sweep[{tiers[0]}/tf32]"}
        cpu_t = _train_setup(ov, "cpu", cpu_sd, regularize="unbiased",
                             config=SDE_CONFIG)
        small = tuple(d[:8] for d in data[0])
        with tiers_of(device):
            _, s_c, g_c = _grads(tm, tl_fn, params0, small, 0.0)
            _, s_r, g_r = _grads(cpu_t[0], cpu_t[1],
                                 {k_: v.cpu() for k_, v in params0.items()},
                                 tuple(d.cpu() for d in small), 0.0)
        first[arm] = _grads(tm, tl_fn, params0, data[0], 0.0)
        same_path = int(s_c["nfe"][0]) == int(s_r["nfe"][0])
        g_tol = grads_tol(tiers, node_tiers(cpu_t[0], device), **SDE_DEPTHS)
        rel_c = max(rel_err(g_c[k_].cpu(), g_r[k_]) for k_ in g_r)
        print(f"[tf32 sde train unbiased {arm}] ({'/'.join(tiers)}) loss "
              f"{float(tl):.6f} NFE {int(tstats['nfe'][0])} success "
              f"{bool(tstats['solver_success'])} {ms:.3f} ms a step; first "
              f"step vs the CPU at the card's tiers (8 images): NFE "
              f"{int(s_c['nfe'][0])} vs {int(s_r['nfe'][0])}, cross-entropy "
              f"{float(s_c['ce_loss'].detach()):.6f} vs "
              f"{float(s_r['ce_loss'].detach()):.6f}, "
              f"gradients relative max-abs {rel_c:.3e} (tolerance "
              f"{g_tol:.3e} on the same steps, else 5e-2) | launches "
              f"{ {k_: v for k_, v in c.items() if '[' in k_ and v} }")
        check(bool(tstats["solver_success"]) and bool(torch.isfinite(tl))
              and {k_ for k_, v in c.items() if '[' in k_ and v} == want
              and rel_c <= (g_tol if same_path else 5e-2),
              f"tf32 sde train {arm}: launches {c}, expected {want}; or the "
              f"CPU: {rel_c}")
    (_, s_a, g_a), (_, s_h, g_h) = first["auto"], first["highest"]
    rel = max(rel_err(g_a[k_], g_h[k_]) for k_ in g_h)
    print(f"[tf32 sde train unbiased] first step from one state ({B} "
          f"images): NFE auto {int(s_a['nfe'][0])} vs highest "
          f"{int(s_h['nfe'][0])}, cross-entropy "
          f"{float(s_a['ce_loss'].detach()):.6f} vs "
          f"{float(s_h['ce_loss'].detach()):.6f}, reg_val "
          f"{float(s_a['reg_val'].detach()):.6e} vs "
          f"{float(s_h['reg_val'].detach()):.6e}; "
          f"gradients relative max-abs {rel:.3e} (across tiers)")
    for name, r in res.items():
        print(f"[tf32 kernel {name}] device ms a launch {r['ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    return res, counts


def phase_tf32_score(device):
    """The score family at the TF32 tier (``[tf32 score ...]``, the
    reference samplers' backend default): kernels 11 and 6 at TF32 against
    their TF32 plain versions on the card (the same Philox path and steps
    for kernel 11; kernel 6's steps, which TF32's noise in ũ sets at rtol
    1e-4, within two attempts) and as accurate against float64 as those
    plain versions (``as_accurate``: kernel 11 against the float64 solve on
    the same path, kernel 6 against the float64 solution of its ODE),
    bitwise repeatable, their digests, device times beside the FP32
    instantiations in the same call; the refusal of a TF32 solve below rtol
    1e-4 (wrappers and samplers), with every score phase's tolerance at or
    above it. Returns the kernels line's TF32 rows."""
    import torch

    from localregneuralde_tpu_torch.models import (
        sample_probability_flow, sample_vpsde,
    )
    from localregneuralde_tpu_torch.ops.cuda import (
        match_td_score_chain, persistent_pf_solve, persistent_pf_solve_plain,
        persistent_vpsde_solve, persistent_vpsde_solve_plain,
        score_chain_params,
    )
    from localregneuralde_tpu_torch.sde import PhiloxNormals

    tols = (SCORE_TOL, 1e-4, *MODES_SCORE_TOL.values())
    check(min(tols) >= 1e-4,
          f"tf32 score: a score phase's tolerance below 1e-4: {tols}")
    net = _score_net(device)
    chain = match_td_score_chain(net)
    ps = [p.detach() for p in score_chain_params(net, chain)]
    p64 = [p.double() for p in ps]
    u0 = torch.randn((SCORE_B, SCORE_F),
                     generator=torch.Generator().manual_seed(0)).to(device)
    span = (0.0, 1.0 - 1e-3)
    saveat = torch.tensor([span[1]], device=device)
    sched = dict(beta_min=0.1, beta_max=20.0, t1=1.0)
    n_params = sum(p.numel() for p in ps)
    floor = tf32_sum_tol(SCORE_PRODUCTS, max(chain.dims) + 1)
    res = {}

    # kernel 11 at TF32 against its TF32 plain version on the same path
    noise = PhiloxNormals(1234, SCORE_B, SCORE_F, device=device)
    kw = dict(noise=noise, rtol=SCORE_TOL, atol=SCORE_TOL, solver="sosri",
              delta=1 / 6, saveat_arr=saveat, max_steps=SCORE_MAX_STEPS,
              **sched)
    out = persistent_vpsde_solve(ps, chain, u0, span, precision=None, **kw)
    again = persistent_vpsde_solve(ps, chain, u0, span, precision=None, **kw)
    fp = persistent_vpsde_solve(ps, chain, u0, span, **kw)
    digest("K11 tf32", out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = persistent_vpsde_solve_plain(ps, chain, u0, span, tier="tf32",
                                       **kw)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    ref64 = persistent_vpsde_solve_plain(p64, chain, u0.double(), span, **kw)
    steps = [(int(o["naccept"]), int(o["nreject"]))
             for o in (out, ref, ref64, fp)]
    scale = float(ref["y_final"].abs().max())
    err = max_abs(out["y_final"], ref["y_final"])
    s_tol = (1e-3 + tf32_tol(SCORE_PRODUCTS)) * scale
    bitwise = (torch.equal(again["y_final"], out["y_final"])
               and int(again["natt"]) == int(out["natt"]))
    same = steps[0] == steps[1] == steps[2]
    worst, (e, e_p) = as_accurate([out["y_final"]], [ref["y_final"]],
                                  [ref64["y_final"]], floor)
    print(f"[tf32 score vpsde] kernel accepts/rejects {steps[0]}, TF32 plain "
          f"{steps[1]}, float64 plain {steps[2]}, FP32 kernel {steps[3]}; "
          f"y_final vs the TF32 plain max-abs {err:.3e} (tolerance "
          f"{s_tol:.3e}: the FP32 route's band and one evaluation's TF32 "
          f"rounding); vs float64 relative {e:.3e}, the TF32 plain's "
          f"{e_p:.3e}: {worst:.3f} of the gate (at least {floor:.3e}); "
          f"bitwise repeatable {bitwise}; vs FP32 (across tiers) max-abs "
          f"{max_abs(out['y_final'], fp['y_final']):.3e}")
    check(bool(out["success"]) and bool(ref["success"]) and bitwise
          and steps[0] == steps[1] and err <= s_tol,
          f"tf32 score vpsde vs its plain version: {steps}, {err}")
    check(not same or worst <= 1,
          f"tf32 score vpsde vs float64: {e} (plain {e_p})")
    args_t, bar_t, y_t = _vpsde_raw_args(ps, chain, u0, span, saveat, sched,
                                         noise, "tf32")
    args_f, bar_f, _ = _vpsde_raw_args(ps, chain, u0, span, saveat, sched,
                                       noise)
    raw_t = raw_launch("lrnde_vpsde_solve_tf32", *args_t)
    raw_f = raw_launch("lrnde_vpsde_solve", *args_f)
    check((bar_t.zero_(), raw_t())[1] == 0
          and torch.equal(y_t, out["y_final"]),
          "tf32 score vpsde: the raw launch differs from the wrapper's")
    ms_t, ms_f = back_to_back_ms([lambda: (bar_t.zero_(), raw_t())[1],
                                  lambda: (bar_f.zero_(), raw_f())[1]],
                                 n=5, warmup=1)
    natt = sum(steps[0])
    print(f"[tf32 score attribution] kernel 11 back to back: TF32 "
          f"{ms_t:.4f} ms ({1e3 * ms_t / natt:.2f} µs an attempt), FP32 "
          f"{ms_f:.4f} ({1e3 * ms_f / sum(steps[3]):.2f} µs an attempt)")
    res["persistent_vpsde_solve_tf32"] = dict(
        max_abs_err=err, ms=ms_t, plain_ms=plain,
        **tree_bound(natt * 25 * SCORE_B * (-(-SCORE_F // 2)),
                     4 * natt * score_flops(chain.dims, SCORE_B),
                     4 * (3 * SCORE_B * SCORE_F + n_params), PEAK_TF32))

    # kernel 6 at TF32: the flow's steps follow TF32's noise in ũ
    pkw = dict(rtol=1e-4, atol=1e-6, saveat_arr=saveat,
               max_steps=SCORE_MAX_STEPS, **sched)
    out = persistent_pf_solve(ps, chain, u0, span, precision=None, **pkw)
    again = persistent_pf_solve(ps, chain, u0, span, precision=None, **pkw)
    fp = persistent_pf_solve(ps, chain, u0, span, **pkw)
    digest("K6 tf32", out)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = persistent_pf_solve_plain(ps, chain, u0, span, tier="tf32", **pkw)
    torch.cuda.synchronize()
    plain = 1e3 * (time.perf_counter() - t0)
    # the float64 solution at rtol = atol 1e-8 (tighter, the float32 clock
    # of the loop's t and dt stalls it)
    exact = persistent_pf_solve_plain(
        p64, chain, u0.double(), span,
        **dict(pkw, rtol=1e-8, atol=1e-8, max_steps=20000))
    nfe = [int(o["nfe"]) for o in (out, ref, fp, exact)]
    scale = float(ref["y_final"].abs().max())
    err = max_abs(out["y_final"], ref["y_final"])
    bitwise = (torch.equal(again["y_final"], out["y_final"])
               and int(again["nfe"]) == nfe[0])
    worst, (e, e_p) = as_accurate([out["y_final"]], [ref["y_final"]],
                                  [exact["y_final"]], floor)
    print(f"[tf32 score pf] NFE kernel {nfe[0]}, TF32 plain {nfe[1]}, FP32 "
          f"kernel {nfe[2]}, float64 at rtol 1e-8 {nfe[3]}; y_final vs the "
          f"TF32 plain max-abs {err:.3e} of max|y| {scale:.3e}; vs the "
          f"float64 solution relative {e:.3e}, the TF32 plain's {e_p:.3e}: "
          f"{worst:.3f} of the gate (at least {floor:.3e}); bitwise "
          f"repeatable {bitwise}; vs FP32 (across tiers) max-abs "
          f"{max_abs(out['y_final'], fp['y_final']):.3e}")
    check(bool(out["success"]) and bool(ref["success"]) and bitwise
          and bool(exact["success"]) and abs(nfe[0] - nfe[1]) <= 12
          and worst <= 1,
          f"tf32 score pf vs its plain version: NFE {nfe}, {e} (plain {e_p})")
    args_t, bar_t, y_t = _pf_raw_args(ps, chain, u0, span, saveat, sched,
                                      "tf32")
    args_f, bar_f, _ = _pf_raw_args(ps, chain, u0, span, saveat, sched)
    raw_t = raw_launch("lrnde_persistent_pf_tf32", *args_t)
    raw_f = raw_launch("lrnde_persistent_pf", *args_f)
    check((bar_t.zero_(), raw_t())[1] == 0
          and torch.equal(y_t, out["y_final"]),
          "tf32 score pf: the raw launch differs from the wrapper's")
    ms_t, ms_f = back_to_back_ms([lambda: (bar_t.zero_(), raw_t())[1],
                                  lambda: (bar_f.zero_(), raw_f())[1]],
                                 n=10, warmup=1)
    att, att_f = (nfe[0] - 2) // 6, (nfe[2] - 2) // 6
    print(f"[tf32 score attribution] kernel 6 back to back: TF32 {ms_t:.4f} "
          f"ms ({1e3 * ms_t / att:.2f} µs an attempt, {att} attempts), FP32 "
          f"{ms_f:.4f} ({1e3 * ms_f / att_f:.2f} µs, {att_f})")
    res["persistent_pf_solve_tf32"] = dict(
        max_abs_err=err, ms=ms_t, plain_ms=plain,
        **bound(6 * att * score_flops(chain.dims, SCORE_B),
                4 * (4 * SCORE_B * SCORE_F + n_params), PEAK_TF32))

    # the refusal: a TF32 solve below rtol 1e-4, at the wrappers and the
    # samplers (the module's products at the backend default)
    refused = 0
    for call in (
            lambda: persistent_vpsde_solve(ps, chain, u0, span, precision=None,
                                           **dict(kw, rtol=1e-5)),
            lambda: persistent_pf_solve(ps, chain, u0, span, precision=None,
                                        **dict(pkw, rtol=1e-5)),
            lambda: sample_vpsde(None, (64, SCORE_F),
                                 torch.Generator().manual_seed(0),
                                 score_module=net, rtol=1e-5, device=device),
            lambda: sample_probability_flow(
                None, (64, SCORE_F), torch.Generator().manual_seed(0),
                score_module=net, rtol=1e-5, device=device)):
        try:
            call()
        except ValueError:
            refused += 1
    print(f"[tf32 score refusal] {refused} of 4 TF32 calls below rtol 1e-4 "
          f"refused; the score phases' tolerances {tols} are at or above it")
    check(refused == 4, "tf32 score: a TF32 solve below rtol 1e-4 ran")
    for name, r in res.items():
        print(f"[tf32 kernel {name}] device ms a launch {r['ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} "
              f"({r['bound_by']})")
    return res


# the cotangent seeds of kernel 9's TF32 gates, the digests' first, and
# the gate of an output's worst seed, in shares of twice the plain
# version's error: 4 times the plain's on one seed of four
K9_SEEDS = (13, 14, 15, 16)
K9_WORST = 2.0


def k9_accuracy(params, chain, rec, saveat, prec, tiers, floor, first):
    """Kernel 9 at ``tiers`` as accurate against the float64 plain sweep
    as its TF32 plain version, output by output and seed by seed over the
    cotangent seeds ``K9_SEEDS``: an output's share on a seed is the
    kernel's error over twice the plain version's, never below ``floor``
    (one swept step's truncated sums). The gate holds each output's median
    share over the seeds within 1 and its worst seed within
    ``K9_WORST``. The kernel and its plain version are two FP32 orders of
    the same TF32 roundings, so on one seed either can be the luckier draw
    (b2 at tiers 2 on seed 13: 2.7 times the plain's, the CPU's plain
    version on that seed 1.5 times the card's); a fault of the kernel's
    sums shows on most seeds and moves the median. ``first`` is the first
    seed's (kernel, plain, float64) outputs. Prints the per-seed ratios
    (``[tf32 chain sweep seeds ...]``) and, for the seed and output of the
    worst share, the CPU's plain version (another FP32 order of the same
    TF32 sums) and the FP32 instantiation beside them (``[tf32 chain sweep
    attribution]``); returns (the worst median share, the worst seed's
    share, that output's errors on that seed)."""
    import statistics

    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_chain_sweep, persistent_chain_sweep_plain,
    )

    flat = lambda o: [o[0], o[1], *o[2]]  # noqa: E731
    Bc, Fc = rec["knot_us"].shape[1:]
    n_save = saveat.shape[0]
    p64 = [p.double() for p in params]
    names = ["a_u", "a_k"] + [f"{'W' if i % 2 == 0 else 'b'}{i // 2}"
                              for i in range(len(first[0]) - 2)]
    label = "/".join(tiers)

    def sweep_args(seed):
        g = torch.Generator(device=saveat.device).manual_seed(seed)
        ct_ys = torch.randn((n_save, Bc, Fc), generator=g,
                            device=saveat.device)
        ct_y = torch.randn((Bc, Fc), generator=g, device=saveat.device)
        return (params, chain, rec["knot_ts"], rec["knot_us"],
                rec["naccept"], saveat, ct_ys, ct_y)

    errs = {}  # seed -> (kernel errors, plain errors) by output
    for seed in K9_SEEDS:
        if seed == K9_SEEDS[0]:
            ours, plain, exact = first
        else:
            args = sweep_args(seed)
            exact = flat(persistent_chain_sweep_plain(
                p64, chain, *[a_.double() if a_.is_floating_point() else a_
                              for a_ in args[2:]]))
            ours = flat(persistent_chain_sweep(*args, **prec))
            plain = flat(persistent_chain_sweep_plain(*args, tiers=tiers))
        e = [rel_err(a_.double(), x_) for a_, x_ in zip(ours, exact)]
        e_p = [rel_err(p_.double(), x_) for p_, x_ in zip(plain, exact)]
        errs[seed] = (e, e_p)
        print(f"[tf32 chain sweep seeds {label}] seed {seed}: "
              "kernel / TF32 plain error vs float64 by output: " + ", ".join(
                  f"{nm} {a_ / b_:.2f}" for nm, a_, b_ in zip(names, e, e_p)))
    share = {seed: [a_ / max(2 * b_, floor) for a_, b_ in zip(*errs[seed])]
             for seed in K9_SEEDS}
    med = [statistics.median(share[sd][i] for sd in K9_SEEDS)
           for i in range(len(names))]
    i = max(range(len(names)), key=med.__getitem__)
    ws, wi = max(((sd, j) for sd in K9_SEEDS for j in range(len(names))),
                 key=lambda k_: share[k_[0]][k_[1]])
    print(f"[tf32 chain sweep seeds {label}] median share over seeds "
          f"{K9_SEEDS} by output: " + ", ".join(
              f"{nm} {m_:.3f}" for nm, m_ in zip(names, med))
          + f"; worst median {names[i]} {med[i]:.3f} (gate 1), worst seed "
          f"{ws} on {names[wi]} {share[ws][wi]:.3f} (gate {K9_WORST})")
    # the worst seed's witnesses: the CPU's plain version (another FP32
    # order of the same TF32 sums) and the FP32 instantiation's sums
    args = sweep_args(ws)
    ours, plain, exact = (first if ws == K9_SEEDS[0] else (
        flat(persistent_chain_sweep(*args, **prec)),
        flat(persistent_chain_sweep_plain(*args, tiers=tiers)),
        flat(persistent_chain_sweep_plain(
            p64, chain, *[a_.double() if a_.is_floating_point() else a_
                          for a_ in args[2:]]))))
    cpu = flat(persistent_chain_sweep_plain(
        [p.cpu() for p in params], chain, *[a_.cpu() for a_ in args[2:]],
        tiers=tiers))
    fk = flat(persistent_chain_sweep(*args))
    fp = flat(persistent_chain_sweep_plain(*args))
    print(f"[tf32 chain sweep attribution] {label}, seed {ws}, error vs "
          f"float64 by output, the kernel / the card's TF32 plain version / "
          f"the CPU's / the FP32 kernel / the FP32 plain version: " + ", ".join(
              f"{nm} {rel_err(a_.double(), x_):.2e}/"
              f"{rel_err(p_.double(), x_):.2e}/"
              f"{rel_err(c_.double(), x_.cpu()):.2e}/"
              f"{rel_err(f_.double(), x_):.2e}/{rel_err(q_.double(), x_):.2e}"
              for nm, a_, p_, c_, f_, q_, x_ in zip(
                  names, ours, plain, cpu, fk, fp, exact)))
    return med[i], share[ws][wi], (errs[ws][0][wi], errs[ws][1][wi])


def phase_tf32_chain(device):
    """The chain family at the TF32 tier (``[tf32 chain ...]``): kernel 5 at
    TF32 (rtol 1e-4, where 'auto' and 'default' take it; physionet.yaml's
    1.4e-8 refuses it) against its TF32 plain version and as accurate
    against the float64 solution of its ODE (``as_accurate``), at the
    training and the eval shapes and recording, bitwise repeatable; kernel
    9 at tiers 2 (FP32 recompute and replay, TF32 gradients: physionet.yaml's
    shipped route) on kernel 5's FP32 knots and at TF32 throughout on kernel
    5's TF32 knots, dense and two-level (forced, its replay kernel 5's TF32
    attempt, bitwise the forward's knots), each as accurate against the
    float64 plain sweep on the same knots as its TF32 plain version and
    within one transposed step's TF32 rounding of FP32; their digests and
    device times beside the FP32 instantiations. Then the latent model
    through its entry points: physionet.yaml at 'auto' (kernel 5 FP32,
    kernel 9 at fp32/fp32/tf32) and a 'default' arm at rtol 1e-4 with the
    two-level replay forced (knot_window 8: kernels 5 and 9 at TF32), a
    training forward and backward and an eval batch each, with launches by
    tier, against the CPU at the card's tiers. Returns (the kernels line's
    TF32 rows, the paths' launch counts with tiers)."""
    import torch

    from localregneuralde_tpu_torch.harness import create_train_state
    from localregneuralde_tpu_torch.harness.latent_runner import eval_forward
    from localregneuralde_tpu_torch.ode.stored_adjoint import knot_layout
    from localregneuralde_tpu_torch.ops.cuda import (
        persistent_chain_solve, persistent_chain_solve_plain,
        persistent_chain_sweep, persistent_chain_sweep_plain,
        reset_launch_counts,
    )

    params, chain, u0, saveat, latents, test, tgrid = chain_inputs(device)
    p64 = [p.double() for p in params]
    Bc, Fc = u0.shape
    n_save = saveat.shape[0]
    L = len(chain.dims) - 1
    floor = tf32_sum_tol(L, max(chain.dims))
    res = {}

    # kernel 5 at TF32 at the training shape, the eval shape and recording
    kw = dict(rtol=1e-4, atol=1e-4, saveat_arr=saveat, max_steps=10000)
    dense_cap, _, stride = knot_layout(10000)
    u_ev = latents(test, test[0].shape[0])
    kw_ev = dict(kw, saveat_arr=torch.from_numpy(tgrid).to(device))
    rec_kw = dict(kw, record_knots=True, knot_dense_cap=dense_cap,
                  knot_stride=stride)
    errs, solved = [], {}
    for case, u, k_ in (("rtol 1e-4", u0, kw), ("eval", u_ev, kw_ev)):
        out = persistent_chain_solve(params, chain, u, (0.0, 1.0),
                                     precision=None, **k_)
        again = persistent_chain_solve(params, chain, u, (0.0, 1.0),
                                       precision=None, **k_)
        fp = persistent_chain_solve(params, chain, u, (0.0, 1.0), **k_)
        digest(f"K5 {case} tf32", out)
        ref = persistent_chain_solve_plain(params, chain, u, (0.0, 1.0),
                                           tier="tf32", **k_)
        exact = persistent_chain_solve_plain(
            p64, chain, u.double(), (0.0, 1.0),
            **dict(k_, rtol=1e-10, atol=1e-10))
        nfe = [int(o["nfe"]) for o in (out, ref, fp, exact)]
        err = max_abs(out["ys"], ref["ys"])
        bitwise = (torch.equal(again["ys"], out["ys"])
                   and int(again["nfe"]) == nfe[0])
        worst, (e, e_p) = as_accurate([out["ys"]], [ref["ys"]],
                                      [exact["ys"]], floor)
        print(f"[tf32 chain solve {case}] B = {u.shape[0]}: NFE kernel "
              f"{nfe[0]}, TF32 plain {nfe[1]}, FP32 kernel {nfe[2]}, float64 "
              f"at rtol 1e-10 {nfe[3]}; ys vs the TF32 plain max-abs "
              f"{err:.3e}; vs the float64 solution relative {e:.3e}, the "
              f"TF32 plain's {e_p:.3e}: {worst:.3f} of the gate (at least "
              f"{floor:.3e}); bitwise repeatable {bitwise}; vs FP32 (across "
              f"tiers) max-abs {max_abs(out['ys'], fp['ys']):.3e}")
        check(bool(out["success"]) and bool(ref["success"]) and bitwise
              and torch.equal(out["ys"][0], u) and abs(nfe[0] - nfe[1]) <= 12
              and worst <= 1,
              f"tf32 chain solve {case} vs its plain version: NFE {nfe}, "
              f"{e} (plain {e_p})")
        errs.append(err)
        solved[case] = (out, fp)
    rec_t = persistent_chain_solve(params, chain, u0, (0.0, 1.0),
                                   precision=None, **rec_kw)
    out = solved["rtol 1e-4"][0]
    n_t = int(rec_t["naccept"])
    check(torch.equal(rec_t["ys"], out["ys"]) and int(rec_t["nfe"])
          == int(out["nfe"]), "tf32 chain: recording changed the solve")
    digest("K5 record tf32", rec_t["knot_us"][:n_t + 1])
    raws = [chain_raw(params, chain, u0, saveat, 1e-4, tier="tf32"),
            chain_raw(params, chain, u0, saveat, 1e-4)]
    check(all(r() == 0 for r in raws), "tf32 chain solve: raw launch failed")
    ms_t, ms_f = back_to_back_ms(raws, n=20, warmup=2)
    plain, = median_ms([lambda: persistent_chain_solve_plain(
        params, chain, u0, (0.0, 1.0), tier="tf32", **kw)], n=3, warmup=1)
    att = (int(out["nfe"]) - 2) // 6
    att_f = (int(solved["rtol 1e-4"][1]["nfe"]) - 2) // 6
    print(f"[tf32 chain attribution] kernel 5 at rtol 1e-4 back to back: "
          f"TF32 {ms_t:.4f} ms ({1e3 * ms_t / att:.2f} µs an attempt, {att} "
          f"attempts), FP32 {ms_f:.4f} ({1e3 * ms_f / att_f:.2f} µs, "
          f"{att_f})")
    n_params = sum(p.numel() for p in params)
    BF = u0.numel()
    res["persistent_chain_solve_tf32"] = dict(
        max_abs_err=max(errs), ms=ms_t, plain_ms=plain,
        **bound(6 * att * chain_flops(chain.dims),
                4 * ((2 + n_save + 1) * BF + n_params), PEAK_TF32))

    # kernel 9: tiers 2 on kernel 5's FP32 knots (physionet.yaml), TF32
    # throughout on kernel 5's TF32 knots (rtol 1e-4), dense and two-level
    g = torch.Generator(device=device).manual_seed(13)
    ct_ys = torch.randn((n_save, Bc, Fc), generator=g, device=device)
    ct_y = torch.randn(u0.shape, generator=g, device=device)
    rec32 = persistent_chain_solve(
        params, chain, u0, (0.0, 1.0),
        **dict(rec_kw, rtol=LATENT_TOL, atol=LATENT_TOL))
    flat = lambda o: [o[0], o[1], *o[2]]  # noqa: E731
    cases = (("tf32g", rec32, dict(precision="highest", grad_precision=None),
              ("fp32", "fp32", "tf32")),
             ("tf32", rec_t, dict(precision=None, grad_precision=None),
              ("tf32", "tf32", "tf32")))
    for label, rec, prec, tiers in cases:
        n = int(rec["naccept"])
        args = (params, chain, rec["knot_ts"], rec["knot_us"],
                rec["naccept"], saveat, ct_ys, ct_y)
        args64 = (p64, chain) + tuple(
            a_.double() if a_.is_floating_point() else a_ for a_ in args[2:])
        exact = flat(persistent_chain_sweep_plain(*args64))
        fp32 = flat(persistent_chain_sweep(*args))
        ours = flat(persistent_chain_sweep(*args, **prec))
        again = flat(persistent_chain_sweep(*args, **prec))
        plain_s = flat(persistent_chain_sweep_plain(*args, tiers=tiers))
        digest(f"K9 state {label}", ours[0], ours[1])
        digest(f"K9 grads {label}", *ours[2:])
        depth = (LATENT_DEPTHS["step_bwd_products"] if tiers[1] == "tf32"
                 else LATENT_DEPTHS["grad_products"]) - 2 * 5
        # one swept step's truncated sums, as the other TF32 sweeps
        g_floor = tf32_sum_tol(depth, max(chain.dims))
        names = ["a_u", "a_k"] + [f"{'W' if i % 2 == 0 else 'b'}{i // 2}"
                                  for i in range(len(ours) - 2)]
        print(f"[tf32 chain sweep {label}] per output vs float64, kernel / "
              f"TF32 plain / kernel vs plain: " + ", ".join(
                  f"{nm} {rel_err(a_.double(), x_):.2e}/"
                  f"{rel_err(p_.double(), x_):.2e}/{rel_err(a_, p_):.2e}"
                  for nm, a_, p_, x_ in zip(names, ours, plain_s, exact)))
        worst, seed_worst, (e, e_p) = k9_accuracy(
            params, chain, rec, saveat, prec, tiers, g_floor,
            (ours, plain_s, exact))
        xt = max(rel_err(a_, b_) for a_, b_ in zip(ours, fp32))
        same = all(torch.equal(a_, b_) for a_, b_ in zip(ours, again))
        print(f"[tf32 chain sweep {'/'.join(tiers)}] (replay/recompute/"
              f"gradients) {n} steps: the worst median share over "
              f"{len(K9_SEEDS)} seeds {worst:.3f} of the gate, the worst "
              f"seed's {seed_worst:.3f} (gate {K9_WORST}: the kernel's error "
              f"vs float64 {e:.3e}, the TF32 plain version's {e_p:.3e}, the "
              f"floor {g_floor:.3e}); bitwise repeatable "
              f"{same}; vs FP32 (across tiers) {xt:.3e}, tolerance "
              f"{tf32_tol(depth):.3e}")
        check(worst <= 1 and seed_worst <= K9_WORST and same,
              f"tf32 chain sweep {label} vs plain")
        check(xt <= tf32_tol(depth), f"tf32 chain sweep {label} vs fp32: {xt}")
        sweep = lambda: persistent_chain_sweep(*args, **prec)  # noqa: E731
        sweep_f = lambda: persistent_chain_sweep(*args)  # noqa: E731
        timed = [sweep, sweep_f]
        if label == "tf32":
            # the two-level branch, forced: its replay is kernel 5's TF32
            # attempt, so it repeats the TF32 forward's knots bitwise
            ctx = {k: rec[k] for k in rec if k.startswith("ckpt_")}
            ctx.update(t_end=1.0, rtol=1e-4, atol=1e-4, max_steps=10000,
                       stride=stride, dense_cap=min(8, n - 1))
            win, replay = persistent_chain_sweep(
                *args, two_level_ctx=ctx, return_replay=True, **prec)
            m = min(n, stride)
            digest("K9 replay tf32", replay[:m + 1])
            rel_w = max(rel_err(p, q) for p, q in zip(flat(win), ours))
            print(f"[tf32 chain sweep two-level] {n} accepts replayed from "
                  f"{(n - 1) // stride + 1} checkpoint(s) with kernel 5's "
                  f"TF32 attempt: bitwise equal to the forward's knots "
                  f"{torch.equal(replay[:m + 1], rec['knot_us'][:m + 1])}; "
                  f"gradients vs the dense branch relative max-abs "
                  f"{rel_w:.3e}")
            check(torch.equal(replay[:m + 1], rec["knot_us"][:m + 1])
                  and rel_w <= 1e-6,
                  "tf32 chain replay does not repeat the TF32 forward")
            timed.append(lambda: persistent_chain_sweep(
                *args, two_level_ctx=ctx, **prec))
        ms = back_to_back_ms(timed, n=10, warmup=2)
        plain, = median_ms([lambda: persistent_chain_sweep_plain(
            *args, tiers=tiers)], n=3, warmup=1)
        print(f"[tf32 chain attribution] kernel 9 {'/'.join(tiers)} back to "
              f"back {ms[0]:.4f} ms ({1e3 * ms[0] / n:.2f} µs a step), FP32 "
              f"{ms[1]:.4f}" + (f", two-level (replay forced) {ms[2]:.4f}"
                                if len(ms) > 2 else ""))
        err = max(max_abs(a_, b_) for a_, b_ in zip(ours, plain_s))
        f_eval = n * chain_flops(chain.dims)
        n_b = 4 * ((n + 1 + n_save + 1 + 2) * BF + 2 * n_params)
        res[f"persistent_chain_sweep_{label}"] = dict(
            max_abs_err=err, ms=ms[0], plain_ms=plain,
            **(bound(19 * f_eval, n_b, PEAK_TF32) if label == "tf32"
               else mixed_bound(7 * f_eval, 12 * f_eval, n_b)))
        if label == "tf32":
            att_r = (int(rec["nfe"]) - 2) // 6
            res["persistent_chain_sweep_replay_tf32"] = dict(
                max_abs_err=err, ms=ms[2], plain_ms=plain,
                **bound(19 * f_eval + 6 * att_r * chain_flops(chain.dims),
                        n_b, PEAK_TF32))

    # --- the latent model: physionet.yaml 'auto' and the 'default' arm
    counts = {}

    def add(c):
        for k_, v in c.items():
            counts[k_] = counts.get(k_, 0) + v

    arms = (("auto", []),
            ("default", ["--model.solver.precision=default",
                         "--model.solver.reltol=1e-4",
                         "--model.solver.abstol=1e-4",
                         "--model.solver.knot_window=8"]))
    _, model0, _, train, test, _ = _latent_setup(device)
    sd = {k_: v.detach().clone() for k_, v in model0.state_dict().items()}
    cpu_sd = {k_: v.cpu() for k_, v in sd.items()}
    batch = _host_batch(train, device, shuffle=True)
    small = tuple(a_[:8] for a_ in batch)
    ev = _host_batch(test, device, n=test[0].shape[0])
    w = (0.0, 0.5)
    for arm, ov in arms:
        _, m_, (loss_fn, _), _, _, _ = _latent_setup(device, ov, sd)
        tiers = node_tiers(m_, device)
        fwd = tiers[0]
        params_ = {k_: v.detach() for k_, v in m_.named_parameters()}
        _grads(m_, loss_fn, params_, batch, w)
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        _, st, _ = _grads(m_, loss_fn, params_, batch, w)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        c = tier_counts()
        add(c)
        want = {f"persistent_chain_solve[{fwd}]",
                f"persistent_chain_sweep[{fwd}/{fwd}/{tiers[1]}]"}
        got = {k_ for k_, v in c.items() if "[" in k_ and v}
        nfe = int(st["nfe"])
        cpu = _latent_setup("cpu", ov, cpu_sd)
        with tiers_of(device):
            _, s_c, g_c = _grads(m_, loss_fn, params_, small, w)
            _, s_r, g_r = _grads(cpu[1], cpu[2][0],
                                 {k_: v.cpu() for k_, v in params_.items()},
                                 tuple(a_.cpu() for a_ in small), w)
        same_path = int(s_c["nfe"]) == int(s_r["nfe"])
        g_tol = grads_tol(tiers, node_tiers(cpu[1], device), **LATENT_DEPTHS)
        rel_c = max(rel_err(g_c[k_].cpu(), g_r[k_]) for k_ in g_r)
        print(f"[tf32 latent train {arm}] ({'/'.join(tiers)}) a training "
              f"forward and backward of {Bc} series: {ms:.3f} ms, NFE {nfe}, "
              f"NLL {float(st['neg_log_likelihood'].detach()):.6f}, success "
              f"{bool(st['solver_success'])} | launches "
              f"{ {k_: v for k_, v in c.items() if '[' in k_ and v} }; 8 "
              f"series vs the CPU at the card's tiers: NFE "
              f"{int(s_c['nfe'])} vs {int(s_r['nfe'])}, gradients relative "
              f"max-abs {rel_c:.3e} (tolerance {g_tol:.3e} on the same "
              f"steps, else 5e-2)")
        check(bool(st["solver_success"]) and got == want
              and rel_c <= (g_tol if same_path else 5e-2),
              f"tf32 latent train {arm}: launches {got}, expected {want}; or "
              f"the CPU {rel_c}")
        ts_ = create_train_state(m_)
        reset_launch_counts()
        t0 = time.perf_counter()
        mse, nfe_ev = eval_forward(m_, ts_, ev)
        mse, nfe_ev = float(mse), int(nfe_ev)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        c = tier_counts()
        add(c)
        print(f"[tf32 latent eval {arm}] batch of {ev[0].shape[0]}: masked "
              f"MSE {mse:.6f}, NFE {nfe_ev}, {ms:.3f} ms | launches "
              f"{ {k_: v for k_, v in c.items() if '[' in k_ and v} }")
        check({k_: v for k_, v in c.items() if "[" in k_ and v}
              == {f"persistent_chain_solve[{fwd}]": 1} and mse == mse,
              f"tf32 latent eval {arm}: launches {c}")
        _latent_vs_cpu(f"[tf32 latent eval {arm}]", m_, cpu[1],
                       tuple(a_[:8] for a_ in ev), device)
    for name, r in res.items():
        print(f"[tf32 kernel {name}] device ms a launch {r['ms']:.4f}, plain "
              f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']})")
    return res, counts


# ------------------------------------------------------------ solver modes

MODES_STEPS = 3        # timed train steps a mode
MODES_SCORE_TOL = {"milstein": 1e-1, "euler_heun": SCORE_TOL}
K123 = {"tdmlp_cluster_kernel": "K1", "step_cluster_kernel": "K2",
        "tsit5_step_bwd_kernel": "K3"}


def _k123(kernels):
    """Launches of K1, K2 and K3 among the port kernels of a profile
    (``_profiled``), from their names."""
    out = {"K1": 0, "K2": 0, "K3": 0}
    for name, n in kernels.items():
        for key, k in K123.items():
            if key in name:
                out[k] += n
    return out


def _mode_steps(step, ts, batches, w_reg, sched, warm=True, profile=True):
    """With ``warm`` one untimed step, then MODES_STEPS timed steps and,
    with ``profile``, one profiled step of ``step`` from ``ts``: (ts,
    [(loss, stats)], [ms], K1/K2/K3 launches of the profiled step, the
    wrappers' launches of the profiled step, or without ``profile`` of the
    timed steps)."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import launch_counts

    if warm:
        ts, _, _ = step(ts, batches[0], w_reg(1), sched(1))
        torch.cuda.synchronize()
    before = launch_counts()
    outs, ms = [], []
    for i in range(MODES_STEPS):
        t0 = time.perf_counter()
        ts, loss, stats = step(ts, batches[i % len(batches)], w_reg(i + 2),
                               sched(i + 2))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        outs.append((loss, stats))
    kernels = {}
    if profile:
        before = launch_counts()
        ts, kernels, _, _ = _profiled(
            lambda: step(ts, batches[0], w_reg(1), sched(1))[0])
    after = launch_counts()
    wrappers = {k: after[k] - before[k] for k in after if after[k] > before[k]}
    return ts, outs, ms, _k123(kernels), wrappers


def _ms_band(ms):
    return (f"{statistics.median(ms):.3f} ms a step (min {min(ms):.3f}, "
            f"max {max(ms):.3f})")


def _route_pair(name, overrides, device, model, loss_fn, params0, data,
                tol):
    """One step's cross-entropy gradients on the kernel route against the
    plain route of the same mode, same parameters and batch; the NFE
    equal or within a fifth of each other, the gradients compared where
    the NFE are equal."""
    sd = model.state_dict()
    plain = _train_setup(overrides + ["--model.use_pallas=off"], device, sd)
    _, s_k, g_k = _grads(model, loss_fn, params0, data, 0.0)
    _, s_p, g_p = _grads(plain[0], plain[1], params0, data, 0.0)
    n_k, n_p = int(s_k["nfe"]), int(s_p["nfe"])
    ce_k, ce_p = float(s_k["ce_loss"]), float(s_p["ce_loss"])
    head = (f"[modes ode {name}] kernel route vs plain route: NFE {n_k} vs "
            f"{n_p}, cross-entropy {ce_k:.6f} vs {ce_p:.6f}")
    tiers = node_tiers(model, device)
    # the classifier computes at TF32 on both routes (cross_entropy_tol)
    ce_tol = cross_entropy_tol(tiers, node_tiers(plain[0], device),
                               s_p["y_pred"])
    if tiers != ("fp32", "fp32"):
        # both routes at these tiers ('auto' at the bench tolerance is
        # TF32): one swept step's TF32 rounding (grads_tol)
        tol = grads_tol(tiers, node_tiers(plain[0], device), tol)
        head += f" (tiers {'/'.join(tiers)}; gradient tolerance {tol:.3e})"
    check(abs(ce_k - ce_p) <= ce_tol and abs(n_k - n_p) <= 0.2 * n_p,
          f"modes {name}: the kernel route disagrees with the plain route")
    if n_k != n_p:
        print(f"{head}; the step sequences differ (f32 noise in the error "
              "estimate), gradients not compared")
        return
    rel = max(rel_err(g_k[k].cpu(), g_p[k].cpu()) for k in g_k)
    print(f"{head}; cross-entropy gradients relative max-abs {rel:.3e} "
          f"(gate {tol:g})")
    check(rel <= tol, f"modes {name}: gradients disagree with the plain "
          "route")


def phase_modes_ode(device):
    """The ODE solver modes on ``mlp.yaml``'s model (B = 512, unbiased):
    the direct, interpolating and backsolve adjoints at the bench
    tolerance, the direct adjoint at the config's own rtol 1.4e-8, VCAB3
    and VCABM3 (and one eval batch each), bfloat16 dynamics on the plain
    route, each after one untimed step, MODES_STEPS timed steps and one
    profiled; each mode's kernel route against its plain route, and the
    direct adjoint against the stored one on one step. Prints each mode's
    ms a step and its K1, K2 and K3 launches a step
    (``torch.profiler``)."""
    import torch

    from localregneuralde_tpu_torch.harness import make_eval_step

    batches = _mnist_batches(device, MODES_STEPS, train=True)
    eval_batch = _mnist_batches(device, 1)[0]
    adj = lambda a: [f"--model.solver.adjoint={a}"]  # noqa: E731
    modes = (
        ("stored", BENCH, 1e-3),
        ("direct", BENCH + adj("direct"), 1e-3),
        ("interpolating", BENCH + adj("interpolating"), 1e-2),
        ("backsolve", BENCH + adj("backsolve"), 1e-2),
        ("vcab3", BENCH + ["--model.solver.ode_solver=vcab3"], 1e-3),
        ("vcabm3", BENCH + ["--model.solver.ode_solver=vcabm3"], 1e-3),
        ("direct mlp.yaml", adj("direct"), None),
        ("bfloat16", BENCH + ["--model.dynamics_compute_dtype=bfloat16"],
         None),
    )
    rows = {}
    for name, overrides, tol in modes:
        model, loss_fn, step, ts, w_reg, sched = _train_setup(overrides,
                                                              device)
        params0 = {k: v.detach().clone() for k, v in ts.params.items()}
        node = model.neural_ode
        if name == "bfloat16":
            check(node.use_pallas == "off" and node.compute_dtype is not None,
                  "modes bfloat16: not on the plain route")
        if name in ("vcab3", "vcabm3"):
            loss, stats = make_eval_step(model, loss_fn)(ts, eval_batch, 0.0)
            print(f"[modes ode {name}] eval batch of {B}: loss "
                  f"{float(loss):.6f} NFE {int(stats['nfe'])} success "
                  f"{bool(stats['solver_success'])}")
            check(bool(torch.isfinite(loss)) and int(stats["nfe"]) > 0,
                  f"modes {name}: bad eval output")
        ts, outs, ms, k123, wrappers = _mode_steps(step, ts, batches, w_reg,
                                                   sched)
        for i, (loss, stats) in enumerate(outs):
            nfe = int(stats["nfe"])
            print(f"[modes ode {name}] step {i}: loss {float(loss):.6f} "
                  f"reg_val {float(stats['reg_val']):.6e} NFE {nfe} success "
                  f"{bool(stats['solver_success'])}")
            check(bool(torch.isfinite(loss)) and nfe > 0
                  and float(stats["reg_val"]) > 0
                  and tuple(stats["y_pred"].shape) == (B, 10),
                  f"modes {name} step {i}: bad output")
        print(f"[modes ode {name}] {_ms_band(ms)}; a step launches {k123} "
              f"(profiler), wrappers {wrappers}")
        rows[name] = dict(ms=statistics.median(ms), k123=k123)
        if name in ("direct", "interpolating", "backsolve"):
            # the TD-MLP route: K1 through FusedTDMLP, K2 (and K3 for the
            # direct scan) through FusedTsit5Step
            need = {"direct": ("K1", "K2", "K3")}.get(name, ("K1", "K2"))
            check(all(k123[k] > 0 for k in need),
                  f"modes {name}: a step launched {k123}, expected {need}")
        if tol is not None:
            _route_pair(name, overrides, device, model, loss_fn, params0,
                        batches[0], tol)
        if name == "direct":
            stored = _train_setup(BENCH, device, model.state_dict())
            _, s_d, g_d = _grads(model, loss_fn, params0, batches[0], 0.0)
            _, s_s, g_s = _grads(stored[0], stored[1], params0, batches[0],
                                 0.0)
            rel = max(rel_err(g_d[k], g_s[k]) for k in g_d)
            # the same tiers: one swept step's TF32 rounding (grads_tol)
            g_tol = grads_tol(node_tiers(model, device),
                              node_tiers(stored[0], device))
            print(f"[modes ode direct] vs the stored adjoint on one step: NFE "
                  f"{int(s_d['nfe'])} vs {int(s_s['nfe'])}, cross-entropy "
                  f"gradients relative max-abs {rel:.3e} (tolerance "
                  f"{g_tol:.3e})")
            check(int(s_d["nfe"]) == int(s_s["nfe"]) and rel <= g_tol,
                  "modes direct: disagrees with the stored adjoint")
        del model, step, ts
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def phase_modes_sde(device):
    """The MNIST-SDE model (32 -> 64 -> 32, B = 512, unbiased) with the
    other solvers: Milstein, Milstein with sde_noise_dims = 3 (matrix
    noise, Dense(32, 96) diffusion) and Euler–Heun, one eval batch each and
    MODES_STEPS timed train steps under the stored and the direct adjoint
    (the first with its set-up), and SOSRI under the direct adjoint. These run the eager loop on the
    modules (the SDE kernels serve SRI/SOSRI with diagonal noise under the
    stored adjoint only, as the reference's)."""
    import torch

    from localregneuralde_tpu_torch.harness import make_eval_step

    batches = _mnist_batches(device, MODES_STEPS, train=True)
    eval_batch = _mnist_batches(device, 1)[0]
    solvers = (("milstein", ["--model.sde_solver=milstein"]),
               ("milstein m=3", ["--model.sde_solver=milstein",
                                 "--model.sde_noise_dims=3"]),
               ("euler_heun", ["--model.sde_solver=euler_heun"]),
               ("sosri", ["--model.sde_solver=sosri"]))
    rows = {}
    for name, ov in solvers:
        for adjoint in ("stored", "direct"):
            if name == "sosri" and adjoint == "stored":
                continue  # K10 + K12: the sde phases above
            overrides = ov + [f"--model.solver.adjoint={adjoint}"]
            model, loss_fn, step, ts, w_reg, sched = _train_setup(
                overrides, device, config=SDE_CONFIG)
            layer = model.neural_dsde
            check(not layer.persistent_step(B, device),
                  f"modes sde {name}: declared a persistent step")
            if adjoint == "stored":
                loss, stats = make_eval_step(model, loss_fn)(ts, eval_batch,
                                                             0.0)
                print(f"[modes sde {name}] eval batch of {B}: loss "
                      f"{float(loss):.6f} NFE (drift) "
                      f"{int(stats['nfe'][0])} success "
                      f"{bool(stats['solver_success'])}")
                check(bool(torch.isfinite(loss)),
                      f"modes sde {name}: bad eval output")
            # the wrappers' launches over the timed steps (no profile: the
            # eager loops' traces of TF32 Dense products outgrow it)
            ts, outs, ms, _, wrappers = _mode_steps(
                step, ts, batches, w_reg, sched, warm=False, profile=False)
            for i, (loss, stats) in enumerate(outs):
                print(f"[modes sde {name} {adjoint}] step {i}: loss "
                      f"{float(loss):.6f} reg_val "
                      f"{float(stats['reg_val']):.6e} NFE (drift) "
                      f"{int(stats['nfe'][0])} success "
                      f"{bool(stats['solver_success'])}")
                check(bool(torch.isfinite(loss))
                      and float(stats["reg_val"]) >= 0
                      and tuple(stats["y_pred"].shape) == (B, 10),
                      f"modes sde {name} {adjoint} step {i}: bad output")
            check(not wrappers, f"modes sde {name}: kernels {wrappers} ran")
            print(f"[modes sde {name} {adjoint}] {_ms_band(ms)}")
            rows[f"{name} {adjoint}"] = statistics.median(ms)
            del model, step, ts
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def phase_modes_score(device):
    """``sample_vpsde`` with Milstein and Euler–Heun at B = SCORE_B on the
    score demo's TDChain (the eager loop: kernel 11 serves SRI/SOSRI only),
    samples/s and the first two moments against an SOSRI draw (kernel 11)
    from the same u_init and Philox seed. Milstein runs at rtol = atol 0.1:
    its error estimate (the scaled step difference, a reference quirk)
    needs ~4x the attempts of Euler–Heun at 1e-2."""
    import torch

    from localregneuralde_tpu_torch.models import sample_vpsde

    net = _score_net(device)
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    kw = dict(max_steps=SCORE_MAX_STEPS, device=device, score_module=net)
    ref, rsol = sample_vpsde(None, (SCORE_B, SCORE_F), gen(), solver="sosri",
                             **kw)
    m_ref, s_ref = ref.mean(0), ref.std(0)
    rows = {}
    for solver, tol in MODES_SCORE_TOL.items():
        sample_vpsde(None, (64, SCORE_F), gen(), solver=solver, rtol=tol,
                     atol=tol, **kw)  # first-call set-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, sol = sample_vpsde(None, (SCORE_B, SCORE_F), gen(), solver=solver,
                              rtol=tol, atol=tol, **kw)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        m, sd = s.mean(0), s.std(0)
        print(f"[modes score {solver}] rtol {tol:g}: {ms:.1f} ms a draw of "
              f"{SCORE_B}, {SCORE_B / (ms / 1e3):.1f} samples/s, accepts "
              f"{int(sol.naccept)} rejects {int(sol.nreject)} NFE "
              f"{int(sol.nfe_drift)}/{int(sol.nfe_diffusion)}; mean "
              f"{m.tolist()} std {sd.tolist()} vs SOSRI's {m_ref.tolist()} "
              f"{s_ref.tolist()} ({int(rsol.naccept)} accepts)")
        check(bool(sol.success) and bool(torch.isfinite(s).all())
              and tuple(s.shape) == (SCORE_B, SCORE_F),
              f"modes score {solver}: bad draw")
        check(bool(((m - m_ref).abs() <= 0.2 * s_ref).all())
              and bool(((sd / s_ref - 1).abs() <= 0.2).all()),
              f"modes score {solver}: moments disagree with SOSRI's")
        rows[solver] = SCORE_B / (ms / 1e3)
    return rows


def phase_cifar_repeat(device):
    """``[cifar repeat]``: CIFAR-10 training, eager, is repeatable with no
    process-wide flag: two runs of MODES_STEPS ``make_train_step`` steps
    from one state (``none`` and ``unbiased``) are bitwise equal, and the
    K-step call (K = MODES_STEPS, eager on this family) is bitwise equal to
    them; prints the ms a step of each arm."""
    import copy

    import torch

    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration, make_multi_train_step,
        make_train_step,
    )

    check(not torch.backends.cudnn.deterministic
          and not torch.backends.cudnn.benchmark,
          "cifar repeat: a process-wide cuDNN flag is set")
    batches = _cifar_batches(device, "train", MODES_STEPS)
    for reg in ("none", "unbiased"):
        cfg = define_configuration([f"--model.regularize={reg}"],
                                   CIFAR_CONFIG)
        model = construct_model(cfg, device=device)
        loss_fn, w_reg = construct_loss(cfg)
        opt, sched = construct_optimizer(cfg)
        step = make_train_step(model, loss_fn, opt)
        ts0 = create_train_state(model, opt)
        ws = [w_reg(i + 1) for i in range(MODES_STEPS)]
        lrs = [sched(i + 1) for i in range(MODES_STEPS)]
        reduce_fn = lambda loss, stats, data: {  # noqa: E731
            "loss": loss.detach(), "nfe": stats["nfe"]}
        runs, ms = [], []
        for _ in range(2):
            ts = copy.deepcopy(ts0)
            t0 = time.perf_counter()
            ts, _, red = _eager_k(step, ts, batches, ws, lrs, reduce_fn)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0) / MODES_STEPS)
            runs.append((ts, red))
        multi = make_multi_train_step(model, loss_fn, opt, reduce_fn)
        stack = tuple(torch.stack([b[i] for b in batches])
                      for i in range(len(batches[0])))
        b, _, red_b = multi(copy.deepcopy(ts0), stack, ws, lrs)
        torch.cuda.synchronize()
        (a, red_a), (a2, red_a2) = runs
        rep, gens, worst = _compare_states(a, a2, red_a, red_a2)
        call, gens_c, worst_c = _compare_states(a, b, red_a, red_b)
        print(f"[cifar repeat {reg}] two eager runs of {MODES_STEPS} steps: "
              f"bitwise {rep} (largest relative difference {worst:.3e}, "
              f"generators {gens}); the K-step call (captured "
              f"{multi.captured}) against them bitwise {call} "
              f"({worst_c:.3e}); {ms[0]:.3f} and {ms[1]:.3f} ms a step, "
              f"summed NFE {int(red_a['nfe'])}")
        check(rep and gens and call and gens_c and not multi.captured,
              f"cifar repeat {reg}: training is not repeatable")
        del a, a2, b, ts0, model
        gc.collect()
        torch.cuda.empty_cache()


def phase_modes(device):
    """Every ``[modes ...]`` phase and ``[cifar repeat]``; returns the
    wrappers' launch counts of the modes' paths (counted from zero)."""
    from localregneuralde_tpu_torch.ops.cuda import (
        launch_counts, reset_launch_counts,
    )

    reset_launch_counts()
    ode = phase_modes_ode(device)
    sde = phase_modes_sde(device)
    score = phase_modes_score(device)
    counts = tier_counts()
    phase_cifar_repeat(device)
    print(json.dumps({"modes": {
        "ode_ms": {k: v["ms"] for k, v in ode.items()},
        "ode_k123": {k: v["k123"] for k, v in ode.items()},
        "sde_ms": sde, "score_samples_per_s": score}}))
    return counts


# --------------------------------------------------------------------------
# the serving export (utils/export.py) and the runners' phase probes

# Device kernels of one call under torch.profiler, by name: the call runs
# between two bursts of int16 fills (a raw profile can lose device events
# at its edges, never inside), and the fills are left out. Run by the
# export phase and, as source, by its loading process.
_KERNEL_NAMES_SRC = '''
def kernel_names(fn):
    import collections, time, torch
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, dtype=torch.int16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(256):
            marker.fill_(1)
        torch.cuda.synchronize()
        time.sleep(0.1)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(0.1)
        for _ in range(256):
            marker.fill_(4)
        torch.cuda.synchronize()
    names = collections.Counter(
        e.name.split("(")[0] for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "FillFunctor<short>" not in e.name)
    return out, dict(names)
'''

# The serving process: it loads each artifact of the manifest through the
# port's loader, ``utils.load_exported`` (a ladder dispatches to the
# smallest program that takes the batch, zero-padded), and saves each
# call's outputs, the device kernels of one call, the operators' launches
# by tier and the median ms a call; it fails if loading imported any model
# code (``models/``, ``harness/``).
_SERVE_CHILD = '''
import statistics, sys
import torch
from localregneuralde_tpu_torch.ops.cuda import serving
from localregneuralde_tpu_torch.utils import load_exported
''' + _KERNEL_NAMES_SRC + '''
WRAPPERS = (serving.persistent_tsit5_solve, serving.persistent_sde_solve,
            serving.persistent_pf_solve, serving.persistent_chain_solve,
            serving.fused_conv_step)


def launches():
    return {f"{w.__name__}[{t}]": n for w in WRAPPERS
            for t, n in w.tier_launches.items()}


results = {}
with torch.no_grad():
    for job in torch.load(sys.argv[1]):
        fn = load_exported(job["path"])
        args = job["args"]
        out = fn(*args)
        res = {"out": out}
        if job.get("thread"):
            res["out2"] = fn(out[1], args[-1])
        for w in WRAPPERS:
            w.tier_launches.clear()
        _, res["kernels"] = kernel_names(lambda: fn(*args))
        res["launches"] = launches()
        times = []
        for i in range(23):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            if i >= 3:
                times.append(start.elapsed_time(end))
        res["ms"] = statistics.median(times)
        results[job["name"]] = res
torch.save(results, sys.argv[2])
port = sorted(m for m in sys.modules
              if m.startswith("localregneuralde_tpu_torch."))
zoo = [m for m in port if m.split(".")[1] in ("models", "harness")]
print(f"[export] the serving process imported {len(port)} modules of the "
      f"port ({', '.join(sorted({m.split('.')[1] for m in port}))}), of "
      f"models/ and harness/ {zoo or 'none'}")
sys.exit(1 if zoo else 0)
'''


# the serving export's latent and CIFAR cases: physionet.yaml at its rtol
# 1.4e-8 (kernel 5 FP32) and at rtol 1e-4 'default' (kernel 5 at TF32);
# cnn.yaml at 'auto' (kernel 13 at TF32), 'highest' (FP32) and with the
# BatchNorms on the batch's statistics
EXPORT_LATENT = {
    "latent physionet.yaml": [],
    "latent default": ["--model.solver.reltol=1e-4",
                       "--model.solver.abstol=1e-4",
                       "--model.solver.precision=default"]}
EXPORT_CIFAR = {
    "cifar auto": [],
    "cifar highest": ["--model.solver.precision=highest"],
    "cifar batch": ["--model.bn_eval_stats=batch"]}


def _live_ms(fn, n=20, warmup=3):
    """Median ms a call of ``fn`` between CUDA events (the serving
    process's method)."""
    return median_ms([fn], n=n, warmup=warmup)[0]


def _serve_in_fresh_process(jobs, tmp):
    """Run ``jobs`` (dicts of ``name``, ``path``, ``args``, ``thread``) in a
    new process that loads them through ``load_exported`` and imports no
    model code (``_SERVE_CHILD``); returns its results by job name."""
    import torch

    manifest, out = os.path.join(tmp, "jobs.pt"), os.path.join(tmp, "res.pt")
    torch.save(jobs, manifest)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", _SERVE_CHILD, manifest, out],
                          capture_output=True, text=True, timeout=600)
    print(proc.stdout.strip())
    print(f"[export] the serving process ran {len(jobs)} artifacts in "
          f"{time.perf_counter() - t0:.1f} s, rc {proc.returncode}")
    check(proc.returncode == 0,
          f"the serving process failed: {proc.stderr[-3000:]}")
    return torch.load(out)


def phase_export(device):
    """The serving export through its entry points (``[export ...]``):
    mlp.yaml's MNIST Neural ODE classifier at full width (B = 512) at its
    rtol 1.4e-8 (kernel 4 FP32) and at rtol 1e-4 'auto' (kernel 4 at TF32),
    the MNIST SDE (kernel 10 at TF32 at 'auto'), frozen and threaded, a
    probability-flow draw of the score demo's network through export_fn
    (kernel 6 at TF32) and a ladder of B = 512 and 1024 served a batch of
    700; each artifact saved, loaded through ``load_exported`` and run in
    a fresh process that imports no model code, held torch.equal to the
    live model (NFE included), its kernels under torch.profiler the live
    model's (the solve's kernel, no plain version's), and its ms a call
    beside the live model's. The latent ODE and the CIFAR classifier too
    (``[export latent ...]``, ``[export cifar ...]``): physionet.yaml on
    the 410-series eval batch at its rtol 1.4e-8 (kernel 5 FP32) and at
    rtol 1e-4 'default' (kernel 5 at TF32), cnn.yaml at B = 32 at 'auto'
    (kernel 13 at TF32), at 'highest' (kernel 13 FP32) and with
    ``eval_stats='batch'``, and a B = 32 and 64 ladder served 40 images;
    each held as the others, its kernels the live call's (kernel 5 once,
    kernel 13's every attempt, no plain version's). Then the phase probes
    (``[export probes]``):
    a short captured bench training run through
    ``run_classification_experiment`` with finite times in its CSV, its
    losses and parameters bitwise those of the same run without probes.
    Returns the launch counts with tiers (the live calls' and the serving
    process's)."""
    import torch

    from localregneuralde_tpu_torch.harness import (
        construct_model, define_configuration,
    )
    from localregneuralde_tpu_torch.models import sample_probability_flow
    from localregneuralde_tpu_torch.models.draws import cloned_generators
    from localregneuralde_tpu_torch.ops.cuda import reset_launch_counts
    from localregneuralde_tpu_torch.utils import (
        export_fn, export_model, export_model_multi, save_exported,
    )
    from localregneuralde_tpu_torch.utils.export import export_state

    ns = {}
    exec(_KERNEL_NAMES_SRC, ns)
    kernel_names = ns["kernel_names"]
    tmp = os.path.join("build", "export")
    os.makedirs(tmp, exist_ok=True)
    x = _mnist_batches(device, 1)[0][0]
    x2 = torch.cat([b[0] for b in _mnist_batches(device, 2)])

    def model_of(config, overrides):
        return construct_model(define_configuration(overrides, config),
                               device=device)

    def live(model, state, inp):
        with torch.no_grad():
            return model(inp, cloned_generators(state), training=False)

    def serve(model, state, inp):
        """The live model's call as a server makes it (its generators
        advance; ``live`` above copies them for the comparisons)."""
        with torch.no_grad():
            return model(inp, state, training=False)

    def path(name):
        return os.path.join(tmp, name + ".lrnde")

    reset_launch_counts()
    jobs, expect = [], {}
    # kernel 4 at both tolerances; the ladder at 1e-4
    for name, overrides in (("ode mlp.yaml", []), ("ode bench", BENCH)):
        model = model_of(CONFIG, overrides)
        st = model.init_state()
        ref = live(model, st, x)
        save_exported(export_model(model, None, st, x, with_state=True),
                      path(name))
        jobs.append(dict(name=name, path=path(name), args=(x,)))
        expect[name] = (model, st, (x,), ref, "cluster_solve_kernel")
        if name == "ode bench":
            save_exported(export_model_multi(model, None, st, x, (512, 1024),
                                             with_state=True),
                          path("ladder"))
            jobs.append(dict(name="ladder", path=path("ladder"),
                             args=(x2[:700],)))
            expect["ladder"] = (model, st, (x2[:700],), None,
                                "cluster_solve_kernel")
    # kernel 10: frozen and threaded
    sde = model_of(SDE_CONFIG, [])
    st = sde.init_state()
    ref = live(sde, st, x)
    save_exported(export_model(sde, None, st, x, with_state=True),
                  path("sde frozen"))
    save_exported(export_model(sde, None, st, x, freeze_state=False),
                  path("sde threaded"))
    jobs += [dict(name="sde frozen", path=path("sde frozen"), args=(x,)),
             dict(name="sde threaded", path=path("sde threaded"),
                  args=(export_state(sde, st, x), x), thread=True)]
    for name in ("sde frozen", "sde threaded"):
        expect[name] = (sde, st, (x,), ref, "sde_solve_kernel")
    # kernel 6: a flow draw of the demo's network, its starting noise the
    # program's argument
    net = _score_net(device)
    u0 = torch.randn((SCORE_B, SCORE_F),
                     generator=torch.Generator().manual_seed(5)).to(device)

    def draw(u):
        s, sol = sample_probability_flow(
            None, (SCORE_B, SCORE_F), None, score_module=net,
            max_steps=SCORE_MAX_STEPS, device=device, u_init=u)
        return s, sol.nfe

    save_exported(export_fn(draw, u0), path("pf draw"))
    pf_ref = draw(u0)
    jobs.append(dict(name="pf draw", path=path("pf draw"), args=(u0,)))
    # kernel 5 and kernel 13's solve: the latent ODE on the runner's eval
    # batch (the whole test split), the CIFAR classifier at B = 32
    families = {}
    for name, overrides in EXPORT_LATENT.items():
        _, f_model, _, _, test, _ = _latent_setup(device, overrides)
        x_lat = torch.cat(_host_batch(test, device, n=test[0].shape[0]), -1)
        families[name] = (f_model, f_model.init_state(), x_lat)
    x_cif = torch.cat([b[0] for b in _cifar_batches(device, "test", 2)])
    for name, overrides in EXPORT_CIFAR.items():
        f_model = model_of(CIFAR_CONFIG, overrides)
        families[name] = (f_model, f_model.init_state(), x_cif[:32])
    for name, (f_model, f_st, inp) in families.items():
        expect[name] = (f_model, f_st, (inp,), live(f_model, f_st, inp), None)
        save_exported(export_model(f_model, None, f_st, inp,
                                   with_state=True), path(name))
        jobs.append(dict(name=name, path=path(name), args=(inp,)))
    f_model, f_st, _ = families["cifar auto"]
    save_exported(export_model_multi(f_model, None, f_st, x_cif[:32],
                                     (32, 64), with_state=True),
                  path("cifar ladder"))
    jobs.append(dict(name="cifar ladder", path=path("cifar ladder"),
                     args=(x_cif[:40],)))
    expect["cifar ladder"] = (f_model, f_st, (x_cif[:40],), None, None)

    res = _serve_in_fresh_process(jobs, tmp)
    counts = tier_counts()
    for r in res.values():
        for k_, v in r["launches"].items():
            counts[k_] = counts.get(k_, 0) + v

    def same(a, b):
        return all(torch.equal(p, q) for p, q in zip(
            torch.utils._pytree.tree_leaves(a),
            torch.utils._pytree.tree_leaves(b)))

    # the ODE artifacts and the ladder
    def served(name, r, live_k, kernel, padding=0):
        """The serving process's kernels against the live call's: the
        solve's kernel once, and no more other kernels than the live call
        and ``padding`` (a plain version's loop launches its products every
        attempt)."""
        solves = sum(v for k_, v in r["kernels"].items() if kernel in k_)
        others = sum(v for k_, v in r["kernels"].items() if "lrnde" not in k_)
        others_live = sum(v for k_, v in live_k.items() if "lrnde" not in k_)
        print(f"[export {name}] device kernels: {kernel} {solves}, other "
              f"kernels {others} (the live call's {others_live}"
              + (f" and the padding's {padding}" if padding else "")
              + f"), the live call's kernels {r['kernels'] == live_k}")
        return solves == 1 and others <= others_live + padding

    for name in ("ode mlp.yaml", "ode bench", "ladder"):
        model, m_st, args, ref_out, kernel = expect[name]
        r = res[name]
        y, st_out = r["out"]
        if name != "ladder":
            y_ref, st_ref = ref_out
            nfe_ref = int(st_ref["neural_ode"]["nfe"])
        nfe = int(st_out["neural_ode"]["nfe"])
        if name == "ladder":
            # the batch of 700 rode the B = 1024 program, zero-padded: the
            # live model on the padded batch, and beside it the unpadded
            # call's NFE (the padding joins the shared error norm)
            padded = torch.cat([args[0], args[0].new_zeros((324,) + tuple(
                args[0].shape[1:]))])
            y_ref, st_ref = live(model, m_st, padded)
            y_ref, nfe_ref = y_ref[:700], int(st_ref["neural_ode"]["nfe"])
            unpadded = int(live(model, m_st, args[0])[1]["neural_ode"]["nfe"])
            print(f"[export ladder] B = 512 and 1024 served 700 rows: NFE "
                  f"{nfe} (the live model on the padded batch {nfe_ref}); "
                  f"the unpadded call's NFE {unpadded}")
        # the ladder against the live call on the padded batch, beside the
        # dispatcher's padding (a zero fill and a concatenation)
        inp = padded if name == "ladder" else args[0]
        _, live_k = kernel_names(lambda: live(model, m_st, inp))
        st_serve = model.init_state()
        ms_live = _live_ms(lambda: serve(model, st_serve, inp))
        print(f"[export {name}] B = {args[0].shape[0]}: loaded in a fresh "
              f"process, equal to the live model {torch.equal(y, y_ref)}, "
              f"NFE {nfe} (live {nfe_ref}); launches {r['launches']}; ms a "
              f"call live {ms_live:.3f}, loaded {r['ms']:.3f}")
        check(served(name, r, live_k, kernel, 2 * (name == "ladder"))
              and torch.equal(y, y_ref)
              and nfe == nfe_ref,
              f"export {name}: the artifact is not the live model: "
              f"{r['kernels']} against {live_k}")
    tiers = (res["ode mlp.yaml"]["launches"], res["ode bench"]["launches"])
    check(tiers == ({"persistent_tsit5_solve[fp32]": 1},
                    {"persistent_tsit5_solve[tf32]": 1}),
          f"export: kernel 4's tiers {tiers}, not FP32 and TF32")
    # kernel 10, frozen and threaded
    y_ref = ref[0]
    yf = res["sde frozen"]["out"][0]
    (y1, st1), (y2, _) = res["sde threaded"]["out"], res["sde threaded"]["out2"]
    _, live_k = kernel_names(lambda: live(sde, st, x))
    st_serve = sde.init_state()
    ms_live = _live_ms(lambda: serve(sde, st_serve, x))
    for name in ("sde frozen", "sde threaded"):
        r = res[name]
        print(f"[export {name}] B = {B}: launches {r['launches']}; ms a "
              f"call live {ms_live:.3f}, loaded {r['ms']:.3f}")
        check(served(name, r, live_k, "sde_solve_kernel")
              and r["launches"] == {"persistent_sde_solve[tf32]": 1},
              f"export {name}: launches {r['launches']}, kernels "
              f"{r['kernels']} against {live_k}")
    print(f"[export sde] the frozen call and the threaded first call equal "
          f"to the live model {torch.equal(yf, y_ref)}, "
          f"{torch.equal(y1, y_ref)}; the threaded second call a new path "
          f"{not torch.equal(y2, y1)} (max-abs {max_abs(y2, y1):.3e})")
    check(torch.equal(yf, y_ref) and torch.equal(y1, y_ref)
          and not torch.equal(y2, y1), "export sde: not the live model")
    # kernel 6
    r = res["pf draw"]
    s, nfe = r["out"]
    _, live_k = kernel_names(lambda: draw(u0))
    ms_live = _live_ms(lambda: draw(u0))
    print(f"[export pf draw] {SCORE_B} samples: equal to the live draw "
          f"{torch.equal(s, pf_ref[0])}, NFE {int(nfe)} (live "
          f"{int(pf_ref[1])}); launches {r['launches']}; ms a draw live "
          f"{ms_live:.3f}, loaded {r['ms']:.3f}")
    check(served("pf draw", r, live_k, "pf_solve_kernel")
          and torch.equal(s, pf_ref[0]) and int(nfe) == int(pf_ref[1])
          and r["launches"] == {"persistent_pf_solve[tf32]": 1},
          "export pf draw: not the live draw")
    # kernel 5 and kernel 13's solve
    live_ms = {}
    for name in (*families, "cifar ladder"):
        model, m_st, args, ref_out, _ = expect[name]
        r = res[name]
        y, st_out = r["out"]
        nfe = int(st_out["neural_ode"]["nfe"])
        inp = args[0]
        if name == "cifar ladder":
            # the 40 images rode the B = 64 program, zero-padded
            inp = torch.cat([inp, inp.new_zeros((24,) + tuple(inp.shape[1:]))])
            y_ref, st_ref = live(model, m_st, inp)
            y_ref = y_ref[:40]
        else:
            y_ref, st_ref = ref_out
        nfe_ref = int(st_ref["neural_ode"]["nfe"])
        _, live_k = kernel_names(lambda: live(model, m_st, inp))
        st_serve = model.init_state()
        live_ms[name] = _live_ms(lambda: serve(model, st_serve, inp))
        tier = node_tiers(model, device)[0]
        if name.startswith("latent"):
            want = {f"persistent_chain_solve[{tier}]": 1}
        else:
            want = {f"fused_conv_step[{tier}]": (nfe - 2) // 6}
        ours = {k_: v for k_, v in r["kernels"].items() if "lrnde" in k_}
        ours_live = {k_: v for k_, v in live_k.items() if "lrnde" in k_}
        others = sum(v for k_, v in r["kernels"].items() if "lrnde" not in k_)
        others_live = sum(v for k_, v in live_k.items()
                          if "lrnde" not in k_)
        padding = 2 * (name == "cifar ladder")
        # kernel 5's launch, or kernel 13's stage algebra (one an attempt)
        mark = "chain_solve_kernel" if name.startswith("latent") \
            else "conv::stage_kernel"
        print(f"[export {name}] B = {args[0].shape[0]}: loaded in a fresh "
              f"process, equal to the live model {torch.equal(y, y_ref)}, "
              f"NFE {nfe} (live {nfe_ref}); launches {r['launches']}; port "
              f"kernels the live call's {ours == ours_live} "
              f"({sum(ours.values())} launches), other kernels {others} (the "
              f"live call's {others_live}"
              + (f" and the padding's {padding}" if padding else "")
              + f"); ms a call live {live_ms[name]:.3f}, loaded "
              f"{r['ms']:.3f}")
        check(torch.equal(y, y_ref) and nfe == nfe_ref
              and r["launches"] == want and ours == ours_live
              and any(mark in k_ for k_ in ours)
              and others <= others_live + padding,
              f"export {name}: the artifact is not the live model: launches "
              f"{r['launches']} (want {want}), kernels {r['kernels']} "
              f"against {live_k}")
    print(json.dumps({"export": {k_: dict(ms=r["ms"], launches=r["launches"],
                                          **({"live_ms": live_ms[k_]}
                                             if k_ in live_ms else {}))
                                 for k_, r in res.items()}}))
    phase_probes(device)
    return counts


def phase_probes(device):
    """A short captured bench training run (rtol 1e-4, unbiased, K = 5)
    through ``run_classification_experiment``, twice: with the phase probes
    and with them replaced by a no-op. The probed run's CSV has finite,
    positive fwd_time and bwd_time and a finite opt_time (clamped at 0 as
    the reference's), and its losses and final parameters are bitwise the
    other run's."""
    import csv

    import numpy as np

    from localregneuralde_tpu_torch.harness import (
        define_configuration, runner,
    )
    from localregneuralde_tpu_torch.harness.checkpoint import load_checkpoint

    import shutil

    out = {}
    shutil.rmtree(os.path.join("build", "probes"), ignore_errors=True)
    for label in ("probed", "plain"):
        root = os.path.join("build", "probes", label)
        cfg = define_configuration(
            BENCH + ["--model.regularize=unbiased", "--train.total_steps=10",
                     "--train.print_frequency=5", "--train.evaluate_every=10",
                     f"--train.checkpoint_dir={root}/c",
                     f"--train.log_dir={root}/l"], CONFIG)
        probes = runner.make_phase_probes
        if label == "plain":
            runner.make_phase_probes = lambda *a: (lambda ts, d, w: (0., 0.))
        try:
            summary = runner.run_classification_experiment(cfg, "bench",
                                                           device=device)
        finally:
            runner.make_phase_probes = probes
        name = os.listdir(os.path.join(root, "l"))[0]
        with open(os.path.join(root, "l", name, "results_train.csv")) as f:
            rows = list(csv.DictReader(f))
        params = load_checkpoint(os.path.join(
            root, "c", name, "model_current.ckpt"))["tstate"]["params"]
        out[label] = (summary, rows, params)
    (summary, rows, params), (_, rows0, params0) = out["probed"], out["plain"]
    keys = ("net_loss", "ce_loss", "reg_val", "nfe")
    same = ([[r[k] for k in keys] for r in rows]
            == [[r[k] for k in keys] for r in rows0]
            and all(np.array_equal(np.asarray(params[k]),
                                   np.asarray(params0[k])) for k in params))
    times = [[float(r[k]) for k in ("fwd_time", "bwd_time", "opt_time",
                                    "step_time")] for r in rows]
    for r, t in zip(rows, times):
        print(f"[export probes] step {r['step']}: fwd_time {1e3 * t[0]:.3f} "
              f"ms, bwd_time {1e3 * t[1]:.3f}, opt_time {1e3 * t[2]:.3f}, "
              f"step_time {1e3 * t[3]:.3f} (K = {summary['steps_per_call']}, "
              f"captured {summary['captured']})")
    print(f"[export probes] losses and parameters bitwise the run without "
          f"probes: {same}")
    check(same and summary["captured"] and len(rows) == 2
          and all(all(np.isfinite(t)) and t[0] > 0 and t[1] > 0
                  and t[2] >= 0 for t in times),
          "export probes: bad time columns or the probes moved the run")


# ---------------------------------------------------------------- [dp ...]
# Data parallelism (localregneuralde_tpu_torch/parallel) at mlp.yaml's full
# width (784 -> 100 -> 784, B = 512, the regulariser on): world 1 over NCCL
# in this process, world 2 over Gloo as two processes on this card (this
# script with --dp-worker), and both runners on two ranks.

DP_STEPS = 3
# the global grid's gated check: 'highest' (FP32) at rtol 1e-4, where the
# error estimate is well above its rounding noise
DP_HIGHEST = ["--model.solver.reltol=1e-4", "--model.solver.abstol=1e-4",
              "--model.solver.max_steps=64",
              "--model.solver.precision=highest"]
DP_AUTO = ["--model.solver.reltol=1e-4", "--model.solver.abstol=1e-4",
           "--model.solver.max_steps=64"]
# the regulariser's gradient is gated where its error estimate stands well
# above float32 rounding (rtol 3e-2, tests/test_torch_train.py); at 1e-4
# it is rounding noise, so there the cross-entropy's gradient is gated
DP_REG = ["--model.solver.reltol=3e-2", "--model.solver.abstol=3e-2",
          "--model.solver.max_steps=64", "--model.solver.precision=highest"]
# (tag, overrides, the parts gated against the single device)
DP_GLOBAL = (("highest", DP_HIGHEST, ("ce",)), ("reg", DP_REG, ("loss",)),
             ("auto", DP_AUTO, ()), ("mlp.yaml", [], ()))
DP_LOSS_RTOL = 1e-5   # the global grid's loss against the single device
DP_GRAD_REL = 1e-3    # its gradients, relative to the largest
# the conv family's gates are these or twice the single device's own
# rounding floor, whichever is larger: its loss and gradients' change under
# a DP_FLOOR_REL relative change of the batch (DP_FLOOR_DRAWS draws of a
# sign an element), the change in the outer BatchNorm's moments that the
# ranks' order of addition makes; the TF32 products of the layers outside
# the NeuralODE (the backend default) and of kernel 14's gradients round
# it up to ~1e-3 (PERF.md §6)
DP_FLOOR_REL, DP_FLOOR_DRAWS = 1e-7, 2
CARD = ""             # nvidia-smi's name and power limit (phase_build)


def _dp_model(overrides, device):
    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        create_train_state, define_configuration,
    )

    cfg = define_configuration(overrides + ["--model.regularize=unbiased"],
                               CONFIG)
    model = construct_model(cfg, device=device)
    loss_fn, w_reg = construct_loss(cfg)
    opt, sched = construct_optimizer(cfg)
    return model, loss_fn, opt, create_train_state(model, opt), w_reg, sched


def _dp_batches(device, rows=B, n=DP_STEPS + 1):
    import torch

    from localregneuralde_tpu_torch.harness import (
        one_hot, synthetic_classification,
    )

    x, y, _, _ = synthetic_classification((28, 28), 1, 10, seed=0)
    return [(torch.tensor(x[i * rows:(i + 1) * rows], device=device),
             torch.tensor(one_hot(y[i * rows:(i + 1) * rows], 10),
                          device=device))
            for i in range(n)]


def _rank_mean(values, n):
    acc = values[0]
    for v in values[1:]:
        acc = acc + v
    return acc / n


def _per_rank_by_hand(model, loss_fn, opt, ts, batch, w, lr, n):
    """The per-rank estimator by hand, on one device: rank r's rows through
    the single-device forward and backward with rank r's draws
    (``parallel.rank_state``), the rank means in rank order, one update of
    a copy of ``ts``. Returns (ts', loss, the ranks' NFE)."""
    import copy

    from localregneuralde_tpu_torch.harness.train import device_w, step_grads
    from localregneuralde_tpu_torch.models.draws import (
        cloned_generators, stage_draws, to_device,
    )
    from localregneuralde_tpu_torch.parallel import rank_state

    rows = int(batch[0].shape[0]) // n
    like = next(iter(ts.params.values()))
    res = []
    for r in range(n):
        st = rank_state(cloned_generators(ts.state), r)
        draws = [to_device(stage_draws(model, st, rows), like)]
        part = tuple(a[r * rows:(r + 1) * rows] for a in batch)
        res.append(step_grads(model, loss_fn, 1, ts, part, device_w(w, like),
                              draws))
    grads = [_rank_mean([x[3][i] for x in res], n)
             for i in range(len(res[0][3]))]
    ts2 = copy.deepcopy(ts)
    opt.apply(ts2.opt_state, list(ts2.params.values()), grads, lr)
    return (ts2, _rank_mean([x[0] for x in res], n),
            [int(x[2]["nfe"]) for x in res])


def _global_grads(model, loss_fn, ts, batch, w, dp=None, out=None):
    """Loss, NFE and gradients of one training step without the update,
    its draws from a copy of the generators (so each call takes the same
    t1): the single-device step's on ``batch``, or with ``dp`` the global
    grid's on this rank's rows (its reductions included). ``out["state"]``
    gets the step's new layer state."""
    from localregneuralde_tpu_torch.harness.train import (
        device_w, stage_step, step_grads,
    )
    from localregneuralde_tpu_torch.models.draws import (
        cloned_generators, to_device,
    )
    from localregneuralde_tpu_torch.parallel.sharded_train import (
        GlobalGridSync, group_paths,
    )

    like = next(iter(ts.params.values()))
    draws = [to_device(d, like) for d in stage_step(
        model, cloned_generators(ts.state), int(batch[0].shape[0]), 1, dp)]
    sync = None
    if dp is not None:
        sync = GlobalGridSync(dp, group_paths(model))
    loss, state, stats, grads = step_grads(
        model, loss_fn, 1, ts, batch, device_w(w, like), draws,
        None if sync is None else sync.state_in)
    if sync is not None:
        loss, state, stats, grads = sync.reduce(loss, state, stats, grads)
    if out is not None:
        out["state"] = state
    return loss, _drift_nfe(stats), [g.detach() for g in grads]


def _drift_nfe(stats) -> int:
    """A step's NFE (the SDE's drift NFE: its stats hold a pair)."""
    nfe = stats["nfe"]
    return int(nfe[0] if isinstance(nfe, (tuple, list)) else nfe)


def _sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed_steps(step, ts, batches, w_reg, sched):
    """``step`` over ``batches`` from ``ts``: ms and NFE of each step (host
    clock, closed by a synchronise)."""
    ms, nfe = [], []
    dev = batches[0][0].device
    for i, data in enumerate(batches):
        _sync(dev)
        t0 = time.perf_counter()
        ts, loss, stats = step(ts, data, w_reg(i + 1), sched(i + 1))
        _sync(dev)
        ms.append(1e3 * (time.perf_counter() - t0))
        nfe.append(_drift_nfe(stats))
    return ts, ms, nfe


def _all_kernels(fn):
    """Every device kernel ``fn`` launches (``torch.profiler``, the window
    between two bursts of int16 marker fills)."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():  # a rehearsal on the CPU
        fn()
        return {}
    marker = torch.zeros(1, dtype=torch.int16, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_EDGE):
            marker.fill_(1)
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_GUARD_S)
        for _ in range(PROFILE_EDGE):
            marker.fill_(4)
        torch.cuda.synchronize()
    return dict(collections.Counter(
        e.name.split("(")[0][:80] for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and "FillFunctor<short>" not in e.name))


def _plain_gemms(names):
    """The dense-product library kernels among ``names`` (cuBLAS and
    CUTLASS GEMMs): the plain TD-MLP's products would launch these."""
    return {k: v for k, v in names.items()
            if any(s in k.lower() for s in ("gemm", "xmma", "cutlass"))}


def _check_kernel_route(tag, dp_names, ref_names, want):
    """The DP step's device kernels: ``want`` (the port's) launched, and no
    GEMM beyond the single-device kernel route's (the classifier's own):
    no plain version of a kernel ran."""
    ours = {k: v for k, v in dp_names.items() if "lrnde" in k}
    extra = {k: v - _plain_gemms(ref_names).get(k, 0)
             for k, v in _plain_gemms(dp_names).items()
             if v > _plain_gemms(ref_names).get(k, 0)}
    print(f"[dp {tag}] profile: port kernels {ours}; GEMMs "
          f"{_plain_gemms(dp_names)} (single device "
          f"{_plain_gemms(ref_names)})")
    check(all(any(w in k for k in ours) for w in want) and not extra,
          f"dp {tag}: kernels {ours} lack {want} or extra GEMMs {extra}")


# --- the global grid of the chain and SDE families at full width
# (physionet.yaml, mnist_sde/mlp.yaml): world 1 in this process, world 2
# in the dp workers, both runners under 'gspmd'

# each case's config and its overrides: mnist_sde_reg is mnist_sde/mlp.yaml
# with its unbiased regulariser on (at the config's weight, 1000), so the
# regulariser's group norms and its normals staged by global row run;
# cifar is cnn.yaml (B = 32) with the unbiased regulariser at its weight,
# 2.5, at 'highest' (FP32 forwards; 'auto', TF32, is its ungated arm,
# DP_CIFAR_AUTO)
DP_FAMILIES = {"physionet": LATENT_CONFIG, "mnist_sde": SDE_CONFIG,
               "mnist_sde_reg": SDE_CONFIG, "cifar": CIFAR_CONFIG}
DP_CASE_ARGS = {"mnist_sde_reg": ["--model.regularize=unbiased"],
                "cifar": ["--model.regularize=unbiased",
                          "--model.solver.precision=highest"]}
DP_CIFAR_AUTO = ["--model.solver.precision=auto"]
# each case's sweep and solve wrappers and their kernels' symbols (the conv
# family's: kernel 14 on every accepted step, kernel 13 on every attempt)
DP_SWEEP = {"physionet": ("persistent_chain_sweep", "chain_sweep_kernel"),
            "mnist_sde": ("persistent_sde_sweep", "sde_sweep_kernel"),
            "mnist_sde_reg": ("persistent_sde_sweep", "sde_sweep_kernel"),
            "cifar": ("fused_conv_step_bwd", "bn_bwd_reduce_kernel")}
DP_SOLVE = {"physionet": ("persistent_chain_solve", "chain_solve_kernel"),
            "mnist_sde": ("persistent_sde_solve", "sde_solve_kernel"),
            "mnist_sde_reg": ("persistent_sde_solve", "sde_solve_kernel"),
            "cifar": ("fused_conv_step", "bn_act_kernel")}


def _dp_family(family, overrides, device, rows=B, n=DP_STEPS + 1):
    """``(model, loss_fn, opt, ts, w_of, sched, batches)`` of the family's
    config with random weights from its seed: ``w_of(step)`` the loss's
    weight (the latent model's (w_reg, w_kl)), ``n`` training batches of
    ``rows`` (the runner's loader's first for PhysioNet; CIFAR's of its
    config's batch, normalised as the runner does)."""
    import torch

    from localregneuralde_tpu_torch.harness import (
        construct_loss, construct_model, construct_optimizer,
        construct_time_series, create_train_state, define_configuration,
        make_dataloader, one_hot, synthetic_classification,
    )
    from localregneuralde_tpu_torch.harness.latent_runner import (
        build_physionet_arrays,
    )

    cfg = define_configuration(list(overrides), DP_FAMILIES[family])
    if family == "physionet":
        train, _, tgrid, _ = build_physionet_arrays(cfg)
        model = construct_time_series(cfg, saveat=torch.from_numpy(tgrid),
                                      device=device)
        loss_fn, (w_reg, w_kl) = construct_loss(cfg)
        loader = iter(make_dataloader(train, rows, shuffle=True, cycle=True,
                                      seed=cfg.seed))
        batches = [tuple(torch.from_numpy(a).to(device)
                         for a in next(loader)) for _ in range(n)]

        def w_of(step):
            return float(w_reg(step)), float(w_kl(step))
    elif family == "cifar":
        from localregneuralde_tpu_torch.harness import get_classification_data
        from localregneuralde_tpu_torch.harness.runner import cifar_normalize

        model = construct_model(cfg, device=device)
        loss_fn, w_reg = construct_loss(cfg)
        x, y, _, _, _ = get_classification_data(cfg)
        rows = int(cfg.dataset.train_batchsize)
        batches = [(torch.tensor(cifar_normalize(x[i * rows:(i + 1) * rows]),
                                 device=device),
                    torch.tensor(one_hot(y[i * rows:(i + 1) * rows], 10),
                                 device=device)) for i in range(n)]

        def w_of(step):
            return float(w_reg(step))
    else:
        model = construct_model(cfg, device=device)
        loss_fn, w_reg = construct_loss(cfg)
        x, y, _, _ = synthetic_classification((28, 28), 1, 10, seed=0)
        batches = [(torch.tensor(x[i * rows:(i + 1) * rows], device=device),
                    torch.tensor(one_hot(y[i * rows:(i + 1) * rows], 10),
                                 device=device)) for i in range(n)]

        def w_of(step):
            return float(w_reg(step))
    opt, sched = construct_optimizer(cfg)
    return (model, loss_fn, opt, create_train_state(model, opt), w_of, sched,
            batches)


def _dp_gated_w(family, w_of):
    """The loss weight of the gated comparisons: the latent model's with
    the regulariser's weight at 0 (its error estimate is float32 noise at
    physionet.yaml's rtol 1.4e-8, PERF.md §6), the SDE's as it is
    (1000; mnist_sde/mlp.yaml trains without the regulariser, the
    mnist_sde_reg case with it)."""
    return (0.0, w_of(1)[1]) if family == "physionet" else w_of(1)


@contextlib.contextmanager
def _sweep_spy(family, record):
    """Within the block: ``record["plain"]`` counts the plain sweeps run
    (the eager stored-adjoint sweeps and the kernels' plain versions; for
    the conv family, whose kernel route sweeps with kernel 14 in the eager
    sweep, the plain versions of kernels 13 and 14), and
    ``record["args"]`` keeps the family's last kernel-sweep call (its
    tensors cloned), ``(args, kwargs)``."""
    import torch

    from localregneuralde_tpu_torch.ode import stored_adjoint as ode_sa
    from localregneuralde_tpu_torch.ops import cuda
    from localregneuralde_tpu_torch.ops.cuda import (
        fused_conv, fused_conv_bwd, fused_sde_sweep, fused_solve_bwd,
    )
    from localregneuralde_tpu_torch.sde import stored_adjoint as sde_sa

    record.setdefault("plain", 0)
    plains = ([(fused_conv, "conv_step_plain"),
               (fused_conv_bwd, "fused_conv_step_bwd_plain")]
              if family == "cifar" else
              [(ode_sa, "eager_sweep"), (sde_sa, "eager_sde_sweep"),
               (fused_solve_bwd, "persistent_chain_sweep_plain"),
               (fused_sde_sweep, "persistent_sde_sweep_plain")])
    saved = [(mod, name, getattr(mod, name)) for mod, name in plains]
    wrapper = DP_SWEEP[family][0]
    real = getattr(cuda, wrapper)

    def counted(fn):
        def plain(*a, **kw):
            record["plain"] += 1
            return fn(*a, **kw)

        return plain

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, (list, tuple)):
            vals = [clone(v) for v in x]
            return type(x)(*vals) if hasattr(x, "_fields") else type(x)(vals)
        return x

    def sweep(*a, **kw):
        record["args"] = (clone(a), clone(kw))
        return real(*a, **kw)

    for mod, name, fn in saved:
        setattr(mod, name, counted(fn))
    setattr(cuda, wrapper, sweep)
    try:
        yield record
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        setattr(cuda, wrapper, real)


def _dp_global_family(family, setup, dp):
    """One global-grid step's loss, NFE and gradients (``_global_grads``
    at ``_dp_gated_w``) on this rank's rows of the first batch, with the
    launches it made, its plain sweeps and its kernel sweep's arguments."""
    from localregneuralde_tpu_torch.ops.cuda import reset_launch_counts
    from localregneuralde_tpu_torch.parallel import shard_batch

    model, loss_fn, _, ts, w_of, _, batches = setup
    record, out = {}, {}
    with _sweep_spy(family, record):
        reset_launch_counts()
        loss, nfe, grads = _global_grads(
            model, loss_fn, ts, shard_batch(batches[0], dp),
            _dp_gated_w(family, w_of), dp, out)
        _sync(batches[0][0].device)
        counts = tier_counts()
    return dict(loss=loss, nfe=nfe, grads=grads, launches=counts,
                plain=record["plain"], args=record.get("args"),
                stats=_running_stats(out["state"]))


def _running_stats(state):
    """Every BatchNorm running stat of a layer state, in the tree's order
    (the CIFAR model's; none for the other families)."""
    if not isinstance(state, dict):
        return []
    here = [state[k] for k in ("mean", "var") if k in state]
    return here + [x for k, v in state.items() if k not in ("mean", "var")
                   for x in _running_stats(v)]


def _dp_single_family(family, setup):
    """The single-device step of ``_dp_global_family`` on the whole first
    batch: its loss, NFE, gradients (and their parameters' names),
    launches and running stats; for the conv family also its rounding
    floor (``_dp_floor``)."""
    from localregneuralde_tpu_torch.ops.cuda import reset_launch_counts

    model, loss_fn, _, ts, w_of, _, batches = setup
    out = {}
    reset_launch_counts()
    loss, nfe, grads = _global_grads(model, loss_fn, ts, batches[0],
                                     _dp_gated_w(family, w_of), out=out)
    _sync(batches[0][0].device)
    ref = dict(loss=loss, nfe=nfe, grads=grads, launches=tier_counts(),
               stats=_running_stats(out["state"]), names=list(ts.params))
    if family == "cifar":
        ref["floor"] = _dp_floor(family, setup, ref)
    return ref


def _dp_floor(family, setup, ref):
    """The single-device step's own change under ``DP_FLOOR_DRAWS``
    ``DP_FLOOR_REL`` relative changes of the batch's inputs: the largest
    relative loss change and gradient change over the largest gradient,
    with its parameter."""
    import torch

    model, loss_fn, _, ts, w_of, _, batches = setup
    x, y = batches[0]
    scale = max(float(g.abs().max()) for g in ref["grads"])
    gen = torch.Generator(device=x.device).manual_seed(1)
    floor = dict(loss=0.0, grads=0.0, worst=None)
    for _ in range(DP_FLOOR_DRAWS):
        sign = torch.randint(0, 2, x.shape, generator=gen, device=x.device)
        moved = x * (1 + DP_FLOOR_REL * (2 * sign.to(x.dtype) - 1))
        loss, _, grads = _global_grads(model, loss_fn, ts, (moved, y),
                                       _dp_gated_w(family, w_of))
        floor["loss"] = max(floor["loss"], abs(float(loss - ref["loss"]))
                            / abs(float(ref["loss"])))
        for name, a, b in zip(ref["names"], grads, ref["grads"]):
            e = float((a - b).abs().max()) / scale
            if e > floor["grads"]:
                floor["grads"], floor["worst"] = e, name
    return floor


def _check_dp_family_route(tag, family, got, ref=None):
    """The global grid's launches: the family's persistent solve (on the
    whole batch) and its sweep kernel once each, no plain sweep; for the
    conv family kernels 13 and 14 at the tier-wise counts of the single
    device's step (``ref``'s launches) where the NFE is its, else at the
    counts its own NFE implies, and no plain conv step."""
    sweep, solve = DP_SWEEP[family][0], DP_SOLVE[family][0]
    launches = {k: v for k, v in got["launches"].items() if v}
    print(f"[dp {tag}] launches of the step {launches}; plain "
          f"{'conv steps' if family == 'cifar' else 'sweeps'} run "
          f"{got['plain']}")
    if family == "cifar":
        want = {k: v for k, v in ref["launches"].items() if v}
        attempts = (got["nfe"] - 2 - 8) // 6
        n13, n14 = launches.get(solve, 0), launches.get(sweep, 0)
        print(f"[dp {tag}] the single device's step {want} at NFE "
              f"{ref['nfe']}")
        check(got["plain"] == 0 and set(launches) == set(want) and (
            launches == want if got["nfe"] == ref["nfe"]
            else n13 == attempts + 1 and 2 <= n14 <= n13),
              f"dp {tag}: the global grid's launches {launches}, plain conv "
              f"steps {got['plain']}")
        return
    check(got["launches"].get(sweep, 0) == 1
          and got["launches"].get(solve, 0) == 1 and got["plain"] == 0,
          f"dp {tag}: the global grid's route {launches}, plain sweeps "
          f"{got['plain']}")


def _check_dp_family_grads(tag, family, got, ref):
    """A global-grid step (``got``) against the single-device shipped
    route's (``ref``, ``_dp_single_family``'s dict): NFE equal (the
    persistent solve runs on the same whole batch; the conv family's
    within 12, its outer BatchNorm's moments added in another order), loss
    and gradients within ``DP_LOSS_RTOL`` and ``DP_GRAD_REL`` (the conv
    family's, or twice its rounding floor where that is larger)."""
    loss_rtol, grad_rel = DP_LOSS_RTOL, DP_GRAD_REL
    floor = ref.get("floor")
    if floor is not None:
        loss_rtol = max(loss_rtol, 2 * floor["loss"])
        grad_rel = max(grad_rel, 2 * floor["grads"])
    loss_ref, nfe_ref, g_ref = ref["loss"], ref["nfe"], ref["grads"]
    scale = max(float(g.abs().max()) for g in g_ref)
    errs = [float((a.to(b.device) - b).abs().max()) / scale
            for a, b in zip(got["grads"], g_ref)]
    err = max(errs)
    worst = ref["names"][errs.index(err)]
    lerr = abs(float(got["loss"]) - float(loss_ref)) / abs(float(loss_ref))
    print(f"[dp {tag}] vs the single-device shipped route: loss "
          f"{float(got['loss']):.7f} vs {float(loss_ref):.7f} (rel "
          f"{lerr:.2e}, tolerance {loss_rtol:.3g}), NFE {got['nfe']} vs "
          f"{nfe_ref}, gradients max-abs / largest {err:.2e} at {worst} "
          f"(tolerance {grad_rel:.3g})" + ("" if floor is None else (
              f"; the single device's floor: loss {floor['loss']:.2e}, "
              f"gradients {floor['grads']:.2e} at {floor['worst']}")))
    nfe_ok = (abs(got["nfe"] - nfe_ref) <= 12 if family == "cifar"
              else got["nfe"] == nfe_ref)
    check(nfe_ok and lerr <= loss_rtol and err <= grad_rel,
          f"dp {tag}: the global grid disagrees with the single-device step")


def _check_dp_sweep(tag, family, args, device):
    """The family's sweep kernel on the global-grid step's own knots and
    cotangents against its plain version at its tiers and the float64
    plain sweep (``as_accurate``; the kernels' TF32 gradient products,
    gated on this one draw at ``K9_WORST`` as kernel 9's worst seed);
    prints the kernel's and the plain version's ms a call."""
    import torch

    from localregneuralde_tpu_torch.ops.cuda import (
        SDEWeights, persistent_chain_sweep, persistent_chain_sweep_plain,
        persistent_sde_sweep, persistent_sde_sweep_plain,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_mlp_bwd import (
        step_bwd_tiers,
    )
    from localregneuralde_tpu_torch.ops.cuda.fused_solve_bwd import (
        sweep_tiers,
    )

    check(args is not None, f"dp {tag}: no kernel sweep ran")
    if args is None:  # a rehearsal off the kernel route
        return
    if family == "cifar":
        # kernel 14 is held against its plain version at this shape (the
        # whole batch of cnn.yaml) in [conv step_bwd] and [tf32 conv ...]
        return
    a, kw = args
    d64 = lambda xs: [x.double() if isinstance(x, torch.Tensor)  # noqa: E731
                      and x.is_floating_point() else x for x in xs]
    if family == "physionet":
        flat = lambda o: [o[0], o[1], *o[2]]  # noqa: E731
        params, chain, *rest = a
        tiers = sweep_tiers(kw["precision"], kw["grad_precision"],
                            kw["recompute_precision"], device)
        ours = flat(persistent_chain_sweep(*a, **kw))
        plain = flat(persistent_chain_sweep_plain(*a, tiers=tiers))
        exact = flat(persistent_chain_sweep_plain(d64(params), chain,
                                                  *d64(rest)))
        depth = (LATENT_DEPTHS["step_bwd_products"] if tiers[1] == "tf32"
                 else LATENT_DEPTHS["grad_products"]) - 2 * 5
        floor = tf32_sum_tol(depth, max(chain.dims))
        fn = lambda: persistent_chain_sweep(*a, **kw)  # noqa: E731
        plain_fn = lambda: persistent_chain_sweep_plain(  # noqa: E731
            *a, tiers=tiers)
    else:
        flat = lambda o: [o[0], *o[1]]  # noqa: E731
        w, *rest = a
        sw = dict(solver=kw["solver"], delta=kw["delta"])
        rec, grad = step_bwd_tiers(kw["precision"], kw["grad_precision"],
                                   device)
        ours = flat(persistent_sde_sweep(*a, **kw))
        plain = flat(persistent_sde_sweep_plain(*a, **sw, tier=rec,
                                                grad_tier=grad))
        exact = flat(persistent_sde_sweep_plain(SDEWeights(*d64(w)),
                                                *d64(rest), **sw))
        depth = (SDE_STEP_BWD_PRODUCTS if rec == "tf32"
                 else SDE_GRAD_PRODUCTS)
        floor = tf32_sum_tol(depth, w.b1.shape[0])
        tiers = (rec, grad)
        fn = lambda: persistent_sde_sweep(*a, **kw)  # noqa: E731
        plain_fn = lambda: persistent_sde_sweep_plain(  # noqa: E731
            *a, **sw, tier=rec, grad_tier=grad)
    worst, (e, e_p) = as_accurate(ours, plain, exact, floor)
    print(f"[dp {tag}] {DP_SWEEP[family][0]} {'/'.join(tiers)} on the "
          f"global grid's knots (naccept {int(rest[2] if family == 'physionet' else rest[4])}): "
          f"vs float64 {e:.3e}, its plain version's {e_p:.3e}: "
          f"{worst:.3f} of the gate (gate {K9_WORST}, at least "
          f"{floor:.3e})")
    check(worst <= K9_WORST, f"dp {tag}: the sweep kernel on the global "
          "grid's knots against its plain version")
    if torch.device(device).type != "cuda":  # a rehearsal: no card to time
        return
    ms, = median_ms([fn], n=10, warmup=2)
    plain_ms, = median_ms([plain_fn], n=3, warmup=1)
    print(f"[dp {tag}] {CARD}: the sweep kernel {ms:.4f} ms a call (one "
          f"wrapper call, CUDA events), its plain version {plain_ms:.4f}; "
          f"max-abs {max(max_abs(x, y) for x, y in zip(ours, plain)):.3e}")


def dp_worker(job_file, rank, port, device="cuda:0"):
    """One rank of the world-2 checks, on ``device`` over Gloo: the per-rank
    step at mlp.yaml and the global grid's gradients at 'highest' rtol 1e-4
    (checked by the parent), timings, profiles and the NFE of the global
    grid at the 'auto' tier and mlp.yaml's rtol."""
    import copy

    import torch

    from localregneuralde_tpu_torch.harness import warmup_model
    from localregneuralde_tpu_torch.ops.cuda import reset_launch_counts
    from localregneuralde_tpu_torch.parallel import (
        make_dp_group, make_sharded_train_step, make_shardmap_train_step,
        multihost, shard_batch,
    )
    from localregneuralde_tpu_torch.parallel.mesh import mean_over_ranks

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    multihost.initialize(rank=rank, world_size=2, master_port=port,
                         backend="gloo", device=device)
    dp = make_dp_group()
    job = torch.load(job_file)
    extra = job["extra"]
    batches = _dp_batches(device, job["rows"])
    data = [shard_batch(b, dp) for b in batches]
    out = {}

    model, loss_fn, opt, ts, w_reg, sched = _dp_model(extra, device)
    multihost.place_train_state(ts, dp)
    step = make_shardmap_train_step(model, loss_fn, opt, dp)
    warmup_model(step, None, ts, data[0], w_reg(1), sched(1))
    _sync(device)
    reset_launch_counts()
    ts1, loss, stats = step(ts, data[0], w_reg(1), sched(1))
    counts = tier_counts()
    out["per_rank"] = dict(
        loss=loss.detach().cpu().clone(), nfe=float(stats["nfe"]),
        launches=counts,
        params={k: v.detach().cpu().clone() for k, v in ts1.params.items()})
    names = _all_kernels(lambda: step(copy.deepcopy(ts1), data[1], w_reg(2),
                                      sched(2)))
    _, ms, nfe = _timed_steps(step, ts1, data[1:], w_reg, sched)
    flat = torch.cat([loss.reshape(1)] + [p.detach().reshape(-1)
                                          for p in ts1.params.values()])
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(20):
        mean_over_ranks(flat, dp)
    _sync(device)
    # host clock: Gloo stages a CUDA tensor through host memory
    reduce_ms = 1e3 * (time.perf_counter() - t0) / 20
    out["per_rank"].update(ms=ms, nfe_steps=nfe, kernels=names,
                           reduce_ms=reduce_ms)

    for tag, overrides, gated in DP_GLOBAL:
        model, loss_fn, opt, ts, w_reg, sched = _dp_model(overrides + extra,
                                                          device)
        res = {}
        for part, w in (("ce", 0.0), ("loss", w_reg(1))):
            if part in gated or part == "loss":
                loss, nfe, grads = _global_grads(model, loss_fn, ts, data[0],
                                                 w, dp)
                res[part] = dict(loss=loss.cpu(), nfe=nfe,
                                 grads=[g.cpu() for g in grads])
        if tag == "highest":
            step = make_sharded_train_step(model, loss_fn, opt, dp)
            warmup_model(step, None, ts, data[0], w_reg(1), sched(1))
            before = tier_counts()
            ts1, _, _ = step(copy.deepcopy(ts), data[0], w_reg(1), sched(1))
            after = tier_counts()
            res["launches"] = {k: after[k] - before[k] for k in after}
            res["kernels"] = _all_kernels(
                lambda: step(copy.deepcopy(ts), data[1], w_reg(2), sched(2)))
            _, res["ms"], res["nfe_steps"] = _timed_steps(
                step, ts, data[1:], w_reg, sched)
            res["reduce_ms"] = reduce_ms
        out[f"global_{tag}"] = res

    # the chain and SDE families on the global grid
    for family, overrides in job["families"].items():
        setup = _dp_family(family, overrides, device, job["rows"])
        got = _dp_global_family(family, setup, dp)
        res = dict(loss=got["loss"].cpu(), nfe=got["nfe"],
                   grads=[g.cpu() for g in got["grads"]],
                   launches=got["launches"], plain=got["plain"])
        model, loss_fn, opt, ts, w_of, sched, batches = setup
        data = [shard_batch(b, dp) for b in batches]
        step = make_sharded_train_step(model, loss_fn, opt, dp)
        warmup_model(step, None, ts, data[0], w_of(1), sched(1))
        res["kernels"] = _all_kernels(lambda: step(
            copy.deepcopy(ts), data[1], w_of(2), sched(2)))
        _, res["ms"], res["nfe_steps"] = _timed_steps(step, ts, data[1:],
                                                      w_of, sched)
        flat = torch.cat([got["loss"].reshape(1)]
                         + [g.reshape(-1) for g in got["grads"]])
        _sync(device)
        t0 = time.perf_counter()
        for _ in range(20):
            mean_over_ranks(flat, dp)
        _sync(device)
        res["reduce_ms"] = 1e3 * (time.perf_counter() - t0) / 20
        if family == "cifar":
            # 'auto' (TF32): u~ is noise there, so its NFE follows rounding
            auto = _dp_family(family, overrides + DP_CIFAR_AUTO, device,
                              job["rows"])
            res["auto_nfe"] = _global_grads(
                auto[0], auto[1], auto[3], shard_batch(auto[6][0], dp),
                auto[4](1), dp)[1]
        out[f"family_{family}"] = res
    torch.save(out, f"{job_file}.rank{rank}")
    torch.distributed.destroy_process_group()
    return 0


def _spawn(args_of, n=2, timeout=900, env_of=None):
    """``n`` processes of ``args_of(rank, port)``; returns their (rc,
    stdout, stderr) after all have ended."""
    from localregneuralde_tpu_torch.parallel.multihost import free_port

    port = free_port()
    here = os.path.dirname(os.path.abspath(__file__))
    procs = [subprocess.Popen(
        args_of(r, port), cwd=here, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=dict(
            os.environ, **({} if env_of is None else env_of(r, port))))
        for r in range(n)]
    outs, deadline = [], time.monotonic() + timeout
    for p in procs:
        try:
            o, e = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
                q.communicate()
            check(False, "dp: a rank did not end in time")
            return []
        outs.append((p.returncode, o, e))
    return outs


def _dp_runner(module, config, extra, tmp, device, mode="shardmap"):
    """Both ranks of a runner on this card over Gloo, ``torchrun``'s
    variables set, with ``train.data_parallel=mode``: rc 0 on both, the
    same train-window values, and rank 0's checkpoint at the canonical
    place."""
    import ast

    args = [config, f"--train.data_parallel={mode}", "--dp_backend=gloo",
            f"--device={device}",
            "--train.print_frequency=2", f"--train.checkpoint_dir={tmp}/ck",
            f"--train.log_dir={tmp}/lg"] + extra
    t0 = time.perf_counter()
    outs = _spawn(
        lambda r, port: [sys.executable, "-m",
                         f"localregneuralde_tpu_torch.harness.{module}",
                         *args],
        env_of=lambda r, port: dict(
            RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
            LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
            MASTER_PORT=str(port)))
    wall = time.perf_counter() - t0
    for r, (rc, o, e) in enumerate(outs):
        if rc != 0:
            print(e[-3000:], file=sys.stderr)
        check(rc == 0, f"dp {module}: rank {r} exited {rc}")
    summaries, windows = [], []
    for _, o, _ in outs:
        lines = o.splitlines()
        summaries.append(ast.literal_eval(
            [ln for ln in lines if ln.startswith("summary:")][0]
            .split(":", 1)[1].strip()))
        windows.append([" ".join(t for t in ln.split()
                                 if not t.split("=")[0].endswith("_time"))
                        for ln in lines if ln.startswith("[") and "/" in
                        ln.split()[0] and "]" in ln.split()[0]])
    ck = os.path.join(summaries[0]["ckpt_dir"], "model_current.ckpt")
    print(f"[dp {module} {mode}] two ranks over Gloo on one card, "
          f"{wall:.1f} s: "
          f"windows {windows[0]}; ranks {[s['rank'] for s in summaries]}; "
          f"rank 0's checkpoint {os.path.exists(ck)}")
    check(windows[0] and windows[0] == windows[1]
          and summaries[1]["ckpt_dir"].endswith("proc1")
          and "proc" not in summaries[0]["ckpt_dir"] and os.path.exists(ck),
          f"dp {module}: the ranks' windows differ or no checkpoint")


def phase_dp(device, extra=(), rows=B, latent_extra=(), family_extra=None):
    """``[dp ...]``: data parallelism at mlp.yaml's full width, and the
    global grid of the chain, SDE and conv families at physionet.yaml's,
    mnist_sde/mlp.yaml's and cnn.yaml's (``extra``, ``latent_extra`` and
    ``family_extra``'s overrides by family, and ``rows`` a batch, narrow
    them for a rehearsal on the CPU; CIFAR's batch is its config's). Returns the launch counts of its
    steps (this process's world-1 steps and the two world-2 ranks')."""
    import copy
    import tempfile

    import torch

    from localregneuralde_tpu_torch.harness import warmup_model
    from localregneuralde_tpu_torch.ops.cuda import reset_launch_counts
    from localregneuralde_tpu_torch.parallel import (
        make_dp_group, make_sharded_train_step, make_shardmap_train_step,
        multihost,
    )

    extra, latent_extra = list(extra), list(latent_extra)
    family_extra = {f: DP_CASE_ARGS.get(f, [])
                    + list((family_extra or {}).get(f, ()))
                    for f in DP_FAMILIES}
    batches = _dp_batches(device, rows)
    path = {}

    def add(c):
        for k, v in c.items():
            path[k] = path.get(k, 0) + v

    # --- world 1 over NCCL (Gloo off the card), in this process
    multihost.initialize(rank=0, world_size=1, device=device,
                         master_port=multihost.free_port())
    dp = make_dp_group()
    model, loss_fn, opt, ts, w_reg, sched = _dp_model(extra, device)
    step = make_shardmap_train_step(model, loss_fn, opt, dp)
    warmup_model(step, None, ts, batches[0], w_reg(1), sched(1))
    ref, ref_loss, _ = _per_rank_by_hand(model, loss_fn, opt, ts, batches[0],
                                         w_reg(1), sched(1), 1)
    reset_launch_counts()
    ts1, loss, stats = step(ts, batches[0], w_reg(1), sched(1))
    _sync(device)
    add(tier_counts())
    same = bool(torch.equal(loss, ref_loss)) and all(
        torch.equal(ts1.params[k], ref.params[k]) for k in ref.params)
    print(f"[dp world1 per-rank] {dp.backend}, B = {rows}: loss {float(loss):.6f}, NFE "
          f"{float(stats['nfe'])}; bitwise the single-device step {same}")
    check(same, "dp world1: the per-rank step is not the single-device one")

    model, loss_fn, opt, ts, w_reg, sched = _dp_model(extra, device)
    plain = _dp_model(["--model.solver.use_persistent=false"] + extra, device)
    step = make_sharded_train_step(model, loss_fn, opt, dp)
    single = make_train_step_of(plain)
    warmup_model(step, None, ts, batches[0], w_reg(1), sched(1))
    warmup_model(single, None, plain[3], batches[0], w_reg(1), sched(1))
    reset_launch_counts()
    ts1, loss, stats = step(ts, batches[0], w_reg(1), sched(1))
    _sync(device)
    counts = tier_counts()
    add(counts)
    ts2, loss2, stats2 = single(plain[3], batches[0], w_reg(1), sched(1))
    same = bool(torch.equal(loss, loss2)) and all(
        torch.equal(ts1.params[k], ts2.params[k]) for k in ts1.params)
    k2 = counts.get("tsit5_step", 0)
    k3 = counts.get("tsit5_step_bwd", 0)
    print(f"[dp world1 global] {dp.backend}, B = {rows}: loss {float(loss):.6f}, NFE "
          f"{int(stats['nfe'])} (non-persistent route {int(stats2['nfe'])}); "
          f"launches K2 {k2}, K3 {k3}, K4 "
          f"{counts.get('persistent_tsit5_solve', 0)}; bitwise the "
          f"non-persistent kernel route's step {same}")
    check(same and k2 > 0 and k3 > 0
          and counts.get("persistent_tsit5_solve", 0) == 0,
          "dp world1: the global-grid step is not the non-persistent route's")
    family_refs = {}
    for family, overrides in family_extra.items():
        setup = _dp_family(family, overrides, device, rows)
        got = _dp_global_family(family, setup, dp)
        add(got["launches"])
        tag = f"world1 {family}"
        # one rank runs the single device's kernels on the same batch
        ref = _dp_single_family(family, setup)
        family_refs[family] = ref
        _check_dp_family_route(tag, family, got, ref)
        same = (bool(torch.equal(got["loss"], ref["loss"]))
                and got["nfe"] == ref["nfe"])
        grads_same = all(torch.equal(a, b)
                         for a, b in zip(got["grads"], ref["grads"]))
        stats_same = len(got["stats"]) == len(ref["stats"]) and all(
            torch.equal(a, b) for a, b in zip(got["stats"], ref["stats"]))
        # the conv family's whole solve is the single device's by
        # construction, its outer BatchNorm's moments a rank mean of one
        gated = family == "cifar"
        print(f"[dp {tag}] {dp.backend}, B = {int(setup[6][0][0].shape[0])}: "
              f"loss {float(got['loss']):.7f}, NFE {got['nfe']}; bitwise the "
              f"single-device shipped route's loss and NFE {same}, "
              f"gradients {grads_same}, {len(ref['stats'])} running stats "
              f"{stats_same}{'' if gated else ' (not gated)'}")
        check(same and (not gated or (grads_same and stats_same)),
              f"dp {tag}: the global grid's step is not the single-device "
              "shipped route's")
        _check_dp_family_grads(tag, family, got, ref)
        _check_dp_sweep(tag, family, got["args"], device)
    torch.distributed.destroy_process_group()

    # --- single-device steps to set the DP steps beside
    model, loss_fn, opt, ts, w_reg, sched = _dp_model(extra, device)
    single = make_train_step_of((model, loss_fn, opt, ts))
    warmup_model(single, None, ts, batches[0], w_reg(1), sched(1))
    _, ms_single, nfe_single = _timed_steps(single, ts, batches[1:], w_reg,
                                            sched)
    ref_names = {}
    half = (batches[0][0][:rows // 2], batches[0][1][:rows // 2])
    ref_names["per_rank"] = _all_kernels(lambda: single(
        copy.deepcopy(ts), half, w_reg(1), sched(1)))
    hi = _dp_model(DP_HIGHEST + ["--model.solver.use_persistent=false"]
                   + extra, device)
    single_hi = make_train_step_of(hi)
    warmup_model(single_hi, None, hi[3], batches[0], w_reg(1), sched(1))
    _, ms_hi, nfe_hi = _timed_steps(single_hi, hi[3], batches[1:], w_reg,
                                    sched)
    ref_names["global"] = _all_kernels(lambda: single_hi(
        copy.deepcopy(hi[3]), half, w_reg(1), sched(1)))

    # --- world 2 over Gloo: two processes on this card
    with tempfile.TemporaryDirectory() as tmp:
        job = os.path.join(tmp, "dp")
        torch.save({"extra": extra, "rows": rows,
                    "families": family_extra}, job)
        outs = _spawn(lambda r, port: [
            sys.executable, os.path.abspath(__file__), "--dp-worker", job,
            str(r), str(port), str(device)])
        for r, (rc, o, e) in enumerate(outs):
            if rc != 0:
                print(e[-3000:], file=sys.stderr)
            check(rc == 0, f"dp world2: rank {r} exited {rc}")
        ranks = [torch.load(f"{job}.rank{r}") for r in range(2)]
        for tmp_name, module, config, args in (
                ("r1", "runner", CONFIG, [
                    "--train.total_steps=4", "--train.evaluate_every=4",
                    "--model.regularize=unbiased"] + extra),
                ("r2", "latent_runner", LATENT_CONFIG, [
                    "--train.total_steps=2", "--train.evaluate_every=2"]
                 + latent_extra)):
            _dp_runner(module, config, args, os.path.join(tmp, tmp_name),
                       device)
        for tmp_name, module, family in (("r3", "latent_runner", "physionet"),
                                         ("r4", "runner", "mnist_sde"),
                                         ("r5", "runner", "cifar")):
            _dp_runner(module, DP_FAMILIES[family], [
                "--train.total_steps=2", "--train.evaluate_every=2"]
                + family_extra[family], os.path.join(tmp, tmp_name), device,
                mode="gspmd")

    # the per-rank step: bitwise the two half-batch steps averaged
    model, loss_fn, opt, ts, w_reg, sched = _dp_model(extra, device)
    ref, ref_loss, ref_nfe = _per_rank_by_hand(model, loss_fn, opt, ts,
                                               batches[0], w_reg(1),
                                               sched(1), 2)
    for r, res in enumerate(ranks):
        pr = res["per_rank"]
        add(pr["launches"])
        same = bool(torch.equal(pr["loss"], ref_loss.cpu())) and all(
            torch.equal(pr["params"][k], ref.params[k].cpu())
            for k in ref.params)
        print(f"[dp world2 per-rank] rank {r}: loss {float(pr['loss']):.6f}, "
              f"NFE {pr['nfe']} (ranks {ref_nfe}); bitwise the two "
              f"half-batch steps averaged {same}; launches of the step "
              f"{ {k: v for k, v in pr['launches'].items() if v} }")
        check(same, f"dp world2 rank {r}: the per-rank step is not the mean "
              "of the half-batch steps")
        _check_kernel_route(f"world2 per-rank rank {r}", pr["kernels"],
                            ref_names["per_rank"],
                            ("cluster_solve_kernel", "adjoint_sweep_kernel"))
    # the global grid: the single-device step's loss and gradients
    for tag, overrides, gated in DP_GLOBAL:
        ref = _dp_model(overrides + extra, device)
        for part, w in (("ce", 0.0), ("loss", ref[4](1))):
            got = [res[f"global_{tag}"].get(part) for res in ranks]
            if got[0] is None:
                continue
            loss_ref, nfe_ref, g_ref = _global_grads(ref[0], ref[1], ref[3],
                                                     batches[0], w)
            scale = max(float(g.abs().max()) for g in g_ref)
            for r, g in enumerate(got):
                err = max(float((a - b.cpu()).abs().max())
                          for a, b in zip(g["grads"], g_ref)) / scale
                lerr = (abs(float(g["loss"]) - float(loss_ref))
                        / abs(float(loss_ref)))
                gate = part in gated
                print(f"[dp world2 global {tag}] rank {r}, "
                      f"{'cross-entropy' if part == 'ce' else 'loss'}: "
                      f"{float(g['loss']):.7f} vs single device "
                      f"{float(loss_ref):.7f} (rel {lerr:.2e}), NFE "
                      f"{g['nfe']} vs {nfe_ref}, gradients max-abs / largest "
                      f"{err:.2e}" + (
                          f" (tolerances {DP_LOSS_RTOL}, {DP_GRAD_REL})"
                          if gate else " (not gated: the regulariser's "
                          "error estimate is rounding noise here)"))
                check(abs(g["nfe"] - nfe_ref) <= 12 and (not gate or (
                    lerr <= DP_LOSS_RTOL and err <= DP_GRAD_REL)),
                      f"dp world2 rank {r}: the global grid ({tag}, {part}) "
                      "disagrees with the single-device step")
            check(got[0]["nfe"] == got[1]["nfe"],
                  f"dp world2: the ranks' NFE differ on the global grid "
                  f"({tag})")
    for r, res in enumerate(ranks):
        g = res["global_highest"]
        add(g["launches"])
        print(f"[dp world2 global highest] rank {r}: launches of the step "
              f"{ {k: v for k, v in g['launches'].items() if v} }")
        check(g["launches"].get("persistent_tsit5_solve", 0) == 0
              and g["launches"].get("tsit5_step", 0) > 0
              and g["launches"].get("tsit5_step_bwd", 0) > 0,
              f"dp world2 rank {r}: the global grid's launches {g['launches']}")
        _check_kernel_route(f"world2 global rank {r}", g["kernels"],
                            ref_names["global"], ("step_cluster_kernel",
                                                  "tsit5_step_bwd_kernel"))
    # the chain and SDE families' global grid on two ranks
    for family, overrides in family_extra.items():
        got = [res[f"family_{family}"] for res in ranks]
        for r, g in enumerate(got):
            tag = f"world2 {family} rank {r}"
            add(g["launches"])
            _check_dp_family_route(tag, family, g, family_refs[family])
            _check_dp_family_grads(tag, family, g, family_refs[family])
            names = g["kernels"]
            ours = {k: v for k, v in names.items() if "lrnde" in k}
            print(f"[dp {tag}] profile: port kernels {ours}")
            check(all(any(sym in k for k in names) for sym in (
                DP_SWEEP[family][1], DP_SOLVE[family][1])),
                  f"dp {tag}: the profile {ours} lacks "
                  f"{DP_SWEEP[family][1]} or {DP_SOLVE[family][1]}")
        check(got[0]["nfe"] == got[1]["nfe"],
              f"dp world2 {family}: the ranks' NFE differ")
        if family == "cifar":
            auto = _dp_family(family, overrides + DP_CIFAR_AUTO, device, rows)
            sd_nfe = _global_grads(auto[0], auto[1], auto[3], auto[6][0],
                                   auto[4](1))[1]
            print(f"[dp world2 cifar auto] 'auto' (TF32, not gated: u~ is "
                  f"rounding noise there, so NFE follows rounding): NFE of "
                  f"the ranks {[g['auto_nfe'] for g in got]}, the single "
                  f"device's {sd_nfe}")
            check(got[0]["auto_nfe"] == got[1]["auto_nfe"],
                  "dp world2 cifar auto: the ranks' NFE differ")
        model, loss_fn, opt, ts, w_of, sched, fb = _dp_family(
            family, overrides, device, rows)
        single = make_train_step_of((model, loss_fn, opt))
        warmup_model(single, None, ts, fb[0], w_of(1), sched(1))
        _, sd_ms, sd_nfe = _timed_steps(single, ts, fb[1:], w_of, sched)
        med = statistics.median(got[0]["ms"])
        print(f"[dp time {family} global] {CARD}: a DP step (2 ranks on one "
              f"card, Gloo) {med:.3f} ms (steps "
              f"{[round(m, 3) for m in got[0]['ms']]}), its all-reduce "
              f"{got[0]['reduce_ms']:.3f} ms "
              f"({100 * got[0]['reduce_ms'] / med:.1f}%), NFE "
              f"{got[0]['nfe_steps']}; the single-device step at B = "
              f"{int(fb[0][0].shape[0])} {statistics.median(sd_ms):.3f} ms, "
              f"NFE {sd_nfe}")
    pr, gh = ranks[0]["per_rank"], ranks[0]["global_highest"]
    for tag, dp_ms, dp_nfe, sd_ms, sd_nfe in (
            ("per-rank mlp.yaml", pr["ms"], pr["nfe_steps"], ms_single,
             nfe_single),
            ("global highest rtol 1e-4", gh["ms"], gh["nfe_steps"], ms_hi,
             nfe_hi)):
        med = statistics.median(dp_ms)
        print(f"[dp time {tag}] {CARD}: a DP step (2 ranks on one card, "
              f"Gloo) {med:.3f} ms (steps {[round(m, 3) for m in dp_ms]}), "
              f"its all-reduce {pr['reduce_ms']:.3f} ms "
              f"({100 * pr['reduce_ms'] / med:.1f}%), NFE {dp_nfe}; the "
              f"single-device step at B = {rows} "
              f"{statistics.median(sd_ms):.3f} ms, NFE {sd_nfe}")
    return path


def make_train_step_of(setup):
    """``make_train_step`` of a ``_dp_model`` (model, loss_fn, opt, ...)."""
    from localregneuralde_tpu_torch.harness import make_train_step

    return make_train_step(setup[0], setup[1], setup[2])


PARTS = ("kernels", "backward", "sde", "chain", "latent", "conv",
         "conv_core", "score", "attribution", "orient", "solve", "ode",
         "cifar", "sde_train", "capture", "modes", "tf32", "tf32_sde",
         "tf32_score", "tf32_chain", "export", "dp")


def partial_run(device, parts, profile=False):
    """``--only=PART[,PART...]``: the kernel checks, digests and timings of
    the named parts of PARTS, without the model paths; prints no kernels
    line and no ok line."""
    bad = set(parts) - set(PARTS)
    check(not bad, f"--only: unknown parts {bad}, expected some of {PARTS}")
    import torch

    w = x = None
    if {"kernels", "backward", "sde", "solve", "ode", "tf32"} & set(parts):
        w, x, _ = phase_kernels(device)
        phase_determinism(w, x)
    if "solve" in parts:
        phase_step_bwd(device, w, x,
                       torch.Generator(device=device).manual_seed(7))
        phase_solve_attribution(w, x)
    if "ode" in parts:
        if "solve" not in parts:
            phase_solve_cluster(w, x)
        phase_tdmlp_attribution(w, x)
        phase_slice(device, profile=profile)
        phase_train(device, profile=profile)
    if "backward" in parts:
        phase_backward_kernels(device, w, x)
    if "sde" in parts:
        phase_sde_kernels(device, w, x)
    if "chain" in parts:
        phase_chain_kernels(device)
    if "latent" in parts:
        phase_latent(device, profile=profile)
    if "sde_train" in parts:
        phase_sde_train(device, profile=profile)
    if "conv" in parts:
        phase_conv_kernels(device)
    if "cifar" in parts:
        phase_cifar(device, profile=profile)
    if "conv_core" in parts:
        phase_conv_core(device)
    if "score" in parts:
        phase_score_kernels(device)
    if "attribution" in parts:
        phase_vpsde_attribution(device)
    if "orient" in parts:
        phase_conv_orient(device)
    if "capture" in parts:
        phase_capture(device)
    if "modes" in parts:
        phase_modes(device)
    if "tf32" in parts:
        phase_tf32(device, w, x)
        phase_tf32_conv(device)
        if "modes" not in parts:
            phase_cifar_repeat(device)
    capture = []
    if "tf32" in parts or "tf32_sde" in parts:
        phase_tf32_sde(device)
        capture += (["mlp.yaml", "bench", "mnist_sde", "cifar"]
                    if "tf32" in parts else ["mnist_sde"])
    if "tf32" in parts or "tf32_score" in parts:
        phase_tf32_score(device)
        phase_score_sampling(device)
    if "tf32" in parts or "tf32_chain" in parts:
        phase_tf32_chain(device)
        capture.append("physionet")
    if "export" in parts:
        phase_export(device)
    if "dp" in parts:
        phase_dp(device)
    if capture and "capture" not in parts:
        # the K-step call bitwise its eager steps: the bench's at TF32,
        # mlp.yaml's with TF32 gradients, the MNIST SDE's and CIFAR's
        # (eager) at TF32, PhysioNet's with kernel 9's TF32 gradients
        phase_capture(device, only=tuple(capture))
    print(json.dumps({"digests": SEEN_DIGESTS}))
    print(f"chip_smoke: partial run of {parts}, every check passed")
    return 0


def main():
    import torch

    if "--dp-worker" in sys.argv[1:]:
        # one rank of phase_dp's world-2 checks, started by phase_dp
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        i = sys.argv.index("--dp-worker")
        job, rank, port, dev = sys.argv[i + 1:i + 5]
        return dp_worker(job, int(rank), int(port), dev)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    profile = "--profile" in sys.argv[1:]
    only = [a.split("=", 1)[1].split(",") for a in sys.argv[1:]
            if a.startswith("--only=")]

    phase_build()
    if only:
        return partial_run(device, only[0], profile)
    w, x, res = phase_kernels(device)
    phase_determinism(w, x)
    phase_solve_attribution(w, x)
    phase_tdmlp_attribution(w, x)
    path_counts = [phase_slice(device, profile=profile)]
    res.update(phase_backward_kernels(device, w, x))
    path_counts.append(phase_train(device, profile=profile))
    tf32_res, tf32_counts = phase_tf32(device, w, x)
    res.update(tf32_res)
    path_counts.append(tf32_counts)
    res.update(phase_sde_kernels(device, w, x))
    path_counts.append(phase_sde_serving(device))
    path_counts.append(phase_sde_train(device, profile=profile))
    sde_res, sde_counts = phase_tf32_sde(device)
    res.update(sde_res)
    path_counts.append(sde_counts)
    path_counts.append(phase_ode_biased(device))
    res.update(phase_chain_kernels(device))
    path_counts.append(phase_latent(device, profile=profile))
    chain_res, chain_counts = phase_tf32_chain(device)
    res.update(chain_res)
    path_counts.append(chain_counts)
    res.update(phase_conv_kernels(device))
    phase_conv_core(device)
    path_counts.append(phase_cifar(device, profile=profile))
    conv_res, conv_counts = phase_tf32_conv(device)
    res.update(conv_res)
    path_counts.append(conv_counts)
    path_counts.append(phase_capture(device))
    path_counts.append(phase_modes(device))
    res.update(phase_score_kernels(device))
    phase_vpsde_attribution(device)
    path_counts.append(phase_score_sampling(device))
    res.update(phase_tf32_score(device))
    path_counts.append(phase_export(device))
    path_counts.append(phase_dp(device))
    orient, orient_counts = phase_conv_orient(device)
    res.update(orient)
    path_counts.append(orient_counts)
    for name in ("persistent_chain_solve", "persistent_chain_sweep"):
        r = res[name]
        print(f"[kernel {name}] max-abs {r['max_abs_err']:.3e} | device time "
              f"per call back to back {r['ms']:.4f} ms, plain "
              f"{r['plain_ms']:.4f} ms | one wrapper call "
              f"{r.pop('call_ms'):.4f} ms | bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']})")
    # each path's launches were counted from zero just before it ran; the
    # TD-MLP wrappers' also by tier (name[tier])
    counts = {k: sum(c.get(k, 0) for c in path_counts)
              for k in set().union(*path_counts)}
    check(all(v > 0 for v in counts.values()),
          f"a kernel was never launched on the main paths: {counts}")
    check(set(DIGESTS) <= set(SEEN_DIGESTS),
          f"digests never taken: {set(DIGESTS) - set(SEEN_DIGESTS)}")
    print(json.dumps({"digests": SEEN_DIGESTS}))

    sources = {
        "tdmlp": ("localregneuralde_tpu_torch/csrc/tdmlp_cluster.cu",
                  "localregneuralde_tpu/ops/pallas/fused_mlp.py:60"),
        "tsit5_step": ("localregneuralde_tpu_torch/csrc/tdmlp_cluster.cu",
                       "localregneuralde_tpu/ops/pallas/fused_mlp.py:69"),
        "persistent_tsit5_solve": (
            "localregneuralde_tpu_torch/csrc/persistent_solve.cu",
            "localregneuralde_tpu/ops/pallas/fused_solve.py:285"),
        "tsit5_step_bwd": (
            "localregneuralde_tpu_torch/csrc/tsit5_step_bwd.cu",
            "localregneuralde_tpu/ops/pallas/fused_mlp_bwd.py:54"),
        "persistent_stored_sweep": (
            "localregneuralde_tpu_torch/csrc/adjoint_sweep.cu",
            "localregneuralde_tpu/ops/pallas/fused_solve_bwd.py:350"),
        "persistent_two_level_sweep": (
            "localregneuralde_tpu_torch/csrc/adjoint_sweep.cu",
            "localregneuralde_tpu/ops/pallas/fused_solve_bwd.py:783"),
        "persistent_two_level_sweep_dense": (
            "localregneuralde_tpu_torch/csrc/adjoint_sweep.cu",
            "localregneuralde_tpu/ops/pallas/fused_solve_bwd.py:783"),
        "persistent_sde_solve": (
            "localregneuralde_tpu_torch/csrc/sde_solve.cu",
            "localregneuralde_tpu/ops/pallas/fused_sde_solve.py:251"),
        "persistent_sde_sweep": (
            "localregneuralde_tpu_torch/csrc/sde_sweep.cu",
            "localregneuralde_tpu/ops/pallas/fused_sde_sweep.py:68"),
        "persistent_chain_solve": (
            "localregneuralde_tpu_torch/csrc/chain_solve.cu",
            "localregneuralde_tpu/ops/pallas/fused_solve.py:865"),
        "persistent_chain_sweep": (
            "localregneuralde_tpu_torch/csrc/chain_sweep.cu",
            "localregneuralde_tpu/ops/pallas/fused_solve_bwd.py:850"),
        "fused_conv_step": (
            "localregneuralde_tpu_torch/csrc/conv_step.cu",
            "localregneuralde_tpu/ops/pallas/fused_conv.py:166"),
        "fused_conv_step_bwd": (
            "localregneuralde_tpu_torch/csrc/conv_step_bwd.cu",
            "localregneuralde_tpu/ops/pallas/fused_conv_bwd.py:82"),
        "persistent_vpsde_solve": (
            "localregneuralde_tpu_torch/csrc/sde_solve.cu",
            "localregneuralde_tpu/ops/pallas/fused_sde_solve.py:835"),
        "persistent_pf_solve": (
            "localregneuralde_tpu_torch/csrc/pf_solve.cu",
            "localregneuralde_tpu/ops/pallas/fused_solve.py:1009"),
        "conv_orient_tap": (
            "localregneuralde_tpu_torch/csrc/conv_orient.cu",
            "scripts/conv_orient_probe.py:93"),
        "conv_orient_im2col": (
            "localregneuralde_tpu_torch/csrc/conv_orient.cu",
            "scripts/conv_orient_probe.py:120"),
    }
    # the TD-MLP and conv families' kernels at each tier: the FP32
    # instantiations and the TF32 ones (kernels 3, 7, 8 and 14 by
    # recompute/gradient tiers, and kernel 8's replay); each row's launches
    # are its tier's on the paths
    tier_rows = {
        "tdmlp": ("tdmlp", "fp32"), "tdmlp_tf32": ("tdmlp", "tf32"),
        "tsit5_step": ("tsit5_step", "fp32"),
        "tsit5_step_tf32": ("tsit5_step", "tf32"),
        "persistent_tsit5_solve": ("persistent_tsit5_solve", "fp32"),
        "persistent_tsit5_solve_tf32": ("persistent_tsit5_solve", "tf32"),
        "tsit5_step_bwd": ("tsit5_step_bwd", "fp32/fp32"),
        "tsit5_step_bwd_tf32grads": ("tsit5_step_bwd", "fp32/tf32"),
        "tsit5_step_bwd_tf32": ("tsit5_step_bwd", "tf32/tf32"),
        "persistent_stored_sweep": ("persistent_stored_sweep", "fp32/fp32"),
        "persistent_stored_sweep_tf32": ("persistent_stored_sweep",
                                         "tf32/tf32"),
        "persistent_two_level_sweep": ("persistent_two_level_sweep",
                                       "fp32/fp32/fp32"),
        # kernel 8's dense branch, timed on the knots the mlp.yaml train
        # step sweeps
        "persistent_two_level_sweep_dense": ("persistent_two_level_sweep",
                                             "fp32/fp32/fp32"),
        "persistent_two_level_sweep_dense_tf32grads": (
            "persistent_two_level_sweep", "fp32/fp32/tf32"),
        "persistent_two_level_sweep_tf32": ("persistent_two_level_sweep",
                                            "tf32/tf32/tf32"),
        # the conv family's, kernel 14 by recompute/gradient tiers
        "fused_conv_step": ("fused_conv_step", "fp32"),
        "fused_conv_step_tf32": ("fused_conv_step", "tf32"),
        "fused_conv_step_bwd": ("fused_conv_step_bwd", "fp32/fp32"),
        "fused_conv_step_bwd_tf32": ("fused_conv_step_bwd", "tf32/tf32"),
        "fused_conv_step_bwd_tf32grads": ("fused_conv_step_bwd",
                                          "fp32/tf32"),
        # the SDE family's, kernel 12 by recompute/gradient tiers
        "persistent_sde_solve": ("persistent_sde_solve", "fp32"),
        "persistent_sde_solve_tf32": ("persistent_sde_solve", "tf32"),
        "persistent_sde_sweep": ("persistent_sde_sweep", "fp32/fp32"),
        "persistent_sde_sweep_tf32": ("persistent_sde_sweep", "tf32/tf32"),
        "persistent_sde_sweep_tf32grads": ("persistent_sde_sweep",
                                           "fp32/tf32"),
        # the score family's and the chain family's, kernel 9 by replay/
        # recompute/gradient tiers (the dense and the two-level TF32 rows
        # share the tiers, so their launches)
        "persistent_vpsde_solve": ("persistent_vpsde_solve", "fp32"),
        "persistent_vpsde_solve_tf32": ("persistent_vpsde_solve", "tf32"),
        "persistent_pf_solve": ("persistent_pf_solve", "fp32"),
        "persistent_pf_solve_tf32": ("persistent_pf_solve", "tf32"),
        "persistent_chain_solve": ("persistent_chain_solve", "fp32"),
        "persistent_chain_solve_tf32": ("persistent_chain_solve", "tf32"),
        "persistent_chain_sweep": ("persistent_chain_sweep",
                                   "fp32/fp32/fp32"),
        "persistent_chain_sweep_tf32g": ("persistent_chain_sweep",
                                         "fp32/fp32/tf32"),
        "persistent_chain_sweep_tf32": ("persistent_chain_sweep",
                                        "tf32/tf32/tf32"),
        "persistent_chain_sweep_replay_tf32": ("persistent_chain_sweep",
                                               "tf32/tf32/tf32"),
    }
    for name, (wrapper, tier) in tier_rows.items():
        if name not in sources:
            sources[name] = sources[wrapper]
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep,
             launches=(counts.get("{}[{}]".format(*tier_rows[name]), 0)
                       if name in tier_rows else counts[name]),
             **res[name])
        for name, (src, rep) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
