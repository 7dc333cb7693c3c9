#!/usr/bin/env python3
"""Drive the PyTorch port (dreamer_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. card:    the card's name and power limit, as nvidia-smi prints them.
2. build:   compile the CUDA kernels under dreamer_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, in
            bf16 at the flagship shapes (GRU cell N = 1, 50, 64 and the
            1500 rows of hold_observe; the whole-scan GRU at T 30 x B 50,
            its carry held bit for bit by a T = 1 relaunch from its own
            states, and at the world-model path's T 1 x B 1500, where on
            bf16-valued states it must equal the GRU cell bit for bit;
            encoder N = 1, 50, 64, the warm start's 1250 frames and the
            world-model update's 1500 under both normalisation tables),
            with its time beside the plain version's, one library call's
            and the least time the card could take (its bound); the
            profiler's device time where CUDA events time the host's
            launches (the GRU cell and torch.gru_cell, the encoder); each
            kernel's launch grid and the tensor-core (HMMA) instructions of
            each instantiation in the built library's SASS (cuobjdump); for
            the encoder cuDNN timed in NCHW and channels_last, the faster
            kept as its library time.
4. policy:  the serving path, Policy.policy_reset then policy_act_observe
            steps with a reset row partway, at the flagship widths of
            configs/car_racer.yaml (read by the port's own YAML reader) with
            weights drawn from a seed, for N = 1 and N = 64 envs; checks the
            outputs, that every step launched each kernel once, and one step
            against the plain versions on the CPU.  Prints ms/step.
5. profile: torch.profiler over a few steps: the device's busy share of a
            step and the kernels that take the most device time.
6. imagine: the whole-rollout imagination kernel against its plain version at
            the flagship shapes (B 50, T 30), at the init's nearly flat prior
            and at a peaked one, and at the drone's widths
            (configs/drone.yaml: B 128, GRU 1024, hiddens 400, 4 actions):
            the whole rollout (first step whose categories differ, share of
            equal categories); the launch itself held step by step
            (``imagine_cuda.hold_rollout``: relaunched at T = 1 over its own
            T x B pre-step states, which must reproduce it bit for bit, and
            that step held to the plain step by ``compare_step``, near ties
            counted); the plain rollout's states as one T = 1 launch
            (``hold_steps``); the HMMA count of the kernel's SASS; times and
            bound at B 50 x T 30, at T 1 x 1500 rows (``hold_steps``' form)
            and at the drone's B 128 x T 30, with the plan's blocks, SMs and
            grid barriers a step.
7. ac_step: the learner's actor-critic half, Trainer.ac_step on a filled
            replay ring at the flagship widths (B 50, T 50, warm start 25,
            horizon 30, 2 epochs): 1 warm-up and 5 timed steps, the launch
            counts of each step (imagine 2, encoder 2, GRU cell 2 x 24), finite
            and unskipped updates, parameters that moved, the target critic's
            tau step, actions and one-hot latents of a dream, the dream's
            kernel launch held step by step (``hold_rollout``) at the path's
            own weights and states, a profile of one step; then one
            ac_update on the card against the same update on the CPU (plain
            versions) from the same weights, batch and noise (a sanity check
            guarding no kernel), with the readings of three faulty kernels
            beside it for the record.
8. train_iteration: the whole learner iteration, Trainer.train_iteration
            (2 world-model updates, then 2 actor-critic updates, step + 1) on
            the same ring: 1 warm-up and TRAIN_ITERATIONS timed iterations,
            ms per iteration and per wm_step, the launch counts of each
            iteration (whole-scan GRU 2, encoder 4, imagine 2, GRU cell
            2 x 30 + 2 x 24), finite unskipped updates, world-model parameters
            that moved, the actor-critic half reading the updated world
            model's kernel layouts, the posterior scan's kernels held at the
            update's own operands (``observe_scan.hold_observe``, the
            whole-scan GRU's h' there equal to the forward's bit for bit), a
            profile of one iteration; then one wm_update on the card against
            the same update on the CPU (a sanity check guarding no kernel).
9. lifecycle: the training lifecycle through its entry point,
            dreamer_tpu_torch.cli.train.main in process on
            configs/car_racer.yaml with the fake env, a short schedule
            (2 kickstart rounds, 4 iterations, evals and checkpoints every 2)
            and a 2,000-step ring, then again with --resume to 6 iterations:
            the resume restoring iteration 4 and the ring, a metrics row with
            finite losses for each of the 6 iterations, best.json and
            agent_best, eval episodes of 50 and 100 steps compacting the eval
            rows from 2 to 1, the GRU cell and encoder launched in rollout and
            in eval and held to their plain versions at those rows (1 and 2),
            every kernel launched; seconds, the median perf/env_steps_per_s,
            perf/learner_s and perf/rollout_s, the eval rewards.
10. async lifecycle: cli.train.main again on configs/car_racer.yaml, with
            env.async_envs over 4 envs and LunarLander-v3's pixel-from-render
            stack (ActionRepeat -> PixelObservation -> ResizeObservation)
            over --env-maker chip_smoke:lunar_lander_stand_in, a stand-in
            base env drawing the fake env's frames at LunarLander's 400 x 600
            render size (the card's machine has no Box2D); 1 kickstart round
            and 2 iterations, then --resume to 3: the workers spawned, with
            PIDs of their own, while CUDA is live here; each round's env
            steps 4 x sequence_length; the GRU cell and encoder launched in
            rollout at 4 rows and held there to their plain versions; eval on
            the in-process farm; the resume restoring the iteration, the ring
            and the farm's seed counter; the medians of perf/rollout_s and
            perf/env_steps_per_s beside the one-env leg's, and the farm's
            step beside one env's step of the same stack in this process.
11. actor-learner lifecycle: cli.train.main on configs/car_racer_64env.yaml
            (64 envs in AsyncEnvFarm's workers, encoder and decoder 48/96,
            batch 128, the host-local float32 actor on the CPU fed a bf16
            weight broadcast, asynchronous checkpoints) on the fake env with
            a 12,800-step ring, 1 kickstart round and 2 iterations, then
            --resume to 3; then 2 iterations with runtime.async_rollout, and
            2 with the card's actor (runtime.rollout_device=default): after
            each broadcast the actor's weights are the learner's rounded to
            bf16, exactly; one broadcast between rounds and none inside one;
            no kernel launched by the host actor's rollout and eval while the
            learner launches all four; the resume restoring the iteration,
            the ring and both generators (the learner's cuda, the actor's cpu)
            as saved; each asynchronous save returning before its file
            lands, LATEST naming the newest, the restored step and weights
            the save's; each overlapped round acting with the weights of
            before its iteration's update, the ring holding every round; a
            metrics row an iteration; each variant's medians, the
            broadcast's ms and MB, each save's blocking and writing ms, the
            host actor's step at several thread counts; then each kernel held
            against its plain version at the operands this learner gave it
            (the encoder over the update's and the warm start's frames, the
            GRU cell at 128 rows, the whole-scan GRU at T 1 over the update's
            rows, the imagination at B 128 x T 30), with its time, plain
            time, library time and bound.
12. data-parallel lifecycle (lifecycle_64env_2rank): cli.train.main on
            configs/car_racer_64env.yaml with the actor-learner leg's cuts
            and runtime.mesh_shape=[2,1], as two spawned ranks on this one
            card over gloo (each on cuda:0 with --dist-backend gloo, 32 envs
            in its AsyncEnvFarm, 64 of the batch's 128 rows, its 32 envs'
            ring), with the 64-env leg's launch counters; 2 iterations, then
            --resume to 3: each rank's learner launching all four kernels
            and its host actor none, the ranks' parameters equal after each
            run, the resume restoring iteration 2 on both, rank 0 alone
            evaluating and writing metrics, every rank's checkpoint shard;
            per rank perf/learner_s, perf/rollout_s and the seconds an
            update spends in collectives, the global perf/env_steps_per_s;
            then the update check (run_update_check, two more ranks): one
            train_iteration of the two ranks against one process's
            n_shards=2 iteration in bf16, gradients and return scale within
            UPDATE_GRAD_RTOL and UPDATE_SCALE_RTOL from a state crafted so
            that each of the four collectives matters (chip_mutants.py
            shows that each left out fails it), and a NaN on one rank
            skipping both; then each kernel held against its plain version
            at each rank's operands.
13. nccl:   the plan's collectives (all-reduce, all-gather, broadcast,
            barrier) through NCCL in a one-rank group on this card.
14. the "kernels" JSON line (each kernel's launches on the main path,
            train_iteration, and by path, the 2-rank leg's per rank; its
            numbers at the 64-env shapes as *_at_64env_* keys, at the 2-rank
            leg's as *_at_2rank_*), then the result line.

It needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "car_racer.yaml"
DRONE = ROOT / "configs" / "drone.yaml"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM bandwidth and dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
# and the f32 rate outside the tensor cores, for products with f32 inputs.
F32_FLOP_PER_S = 67e12

# Each kernel is held to its plain version by the tolerance defined beside its
# wrapper (ops.gru_cuda.tolerance, ops.conv_cuda.tolerance), which says why.
# The parameters that the init leaves zero (the biases, the actor's mu head)
# are drawn ~ N(0, 0.1) for these checks, so that a kernel or a path that
# dropped one would fail them.
ZERO_INIT_STD = 0.1
POLICY_STEPS = 20
WARMUP_STEPS = 2
RESET_STEP = 10
PROFILE_STEPS = 10
AC_STEPS = 5
# The flagship ring holds a few windows (capacity is no width): 4 x 50 steps.
AC_RING = 200
# A trained dynamics prior is peaked; at init it is nearly flat (mean top
# probability about 0.09), where a kernel without unimix would still sample
# the plain version's categories.  The per-step check runs again with the
# prior's output layer scaled by this (mean top probability about 0.7).
PEAKED_PRIOR = 8.0
# The imagination kernel spreads one launch over the whole card: at least
# this many SMs (an H100 has 114 or 132).
MIN_IMAGINE_SMS = 100
# Card against CPU for one ac_update, relative, on the losses and gradient
# norms: the card's kernels and the CPU's plain versions round differently in
# bf16 and may sample another latent category at a near tie, in the warm
# start and in the dream, which moves that row's trajectory; each loss and
# gradient norm is a mean over 50 x 30 terms.  A sanity check of the update
# on the card, guarding no kernel: with a faulty kernel (``kernel_faults``)
# the readings move no further than that drift, so each kernel is held by its
# own check instead (per kernel at the path's shapes, and the imagination at
# the path's own operands by ``hold_rollout``).
AC_CARD_VS_CPU_RTOL = 0.1
# Timed learner iterations, each about a second; the host's clock varies
# between them (it shares its machine), so the median is printed too.
TRAIN_ITERATIONS = 5
# Card against CPU for one wm_update, relative, on the losses and the
# gradient norm: the same reasons as the AC update's (near-tie flips move a
# row's states; each loss is a mean over 50 x 30 terms); a sanity check of the
# update on the card, guarding no kernel.
WM_CARD_VS_CPU_RTOL = 0.1
# The lifecycle, python -m dreamer_tpu_torch.cli.train in process at the
# flagship widths: the fake env (the card's machine has no Box2D), a short
# schedule with two checkpoints and evals in each of two runs (the second
# resumed), and a replay ring of 2,000 of the published 200,000 steps: every
# checkpoint writes the whole ring, and capacity is not a width.
LIFECYCLE = ("env.env_id=fake", "train.random_iterations=2", "train.eval_every=2",
             "train.checkpoint_every=2", "train.eval_episodes=2",
             "train.final_eval_episodes=2", "train.buffer_size=2000")
LIFECYCLE_ITERATIONS = (4, 6)   # the first run's schedule, then the resumed run's
# The lifecycle's two eval episodes end apart (the fake env's 100 steps
# otherwise end both together), so eval compacts its rows from 2 to 1 on the
# card: the row gather and a 1-row eval bucket.
LIFECYCLE_EVAL_STEPS = (50, 100)
# The lifecycle again with a real env's wrapper stack in AsyncEnvFarm's
# spawned workers: 4 envs (the rollout then serves 4 rows, and the farm has
# work to spread), LunarLander-v3's pixel-from-render stack over a stand-in
# base env, a kickstart round and 2 iterations, then a resumed third.
ASYNC_ENV_ID = "LunarLander-v3"
ASYNC_ENVS = 4
ASYNC_LEG = (f"env.env_id={ASYNC_ENV_ID}", "env.async_envs=true", f"env.num_envs={ASYNC_ENVS}",
             "train.random_iterations=1", "train.eval_every=2", "train.checkpoint_every=2",
             "train.eval_episodes=2", "train.final_eval_episodes=2", "train.buffer_size=2000")
ASYNC_ITERATIONS = (2, 3)
ASYNC_MAKER = "chip_smoke:lunar_lander_stand_in"
# LunarLander-v3 renders 400 x 600 RGB frames.
STAND_IN_FRAME = (400, 600)
# The actor-learner split: configs/car_racer_64env.yaml (BASELINE config 3) as
# published (64 envs in AsyncEnvFarm, encoder and decoder 48/96 with hidden
# 400, batch 128, the host-local actor fed a bf16 broadcast, asynchronous
# checkpoints) but for these cuts: the fake env (no Box2D on the card's
# machine), a ring of 200 steps an env (12,800 of 512,000: every checkpoint
# writes it whole, and capacity is not a width), a kickstart round, 2
# iterations with an eval and a checkpoint at the second, two short eval
# episodes that end apart.  The first variant is then resumed to 3; the
# other two, the overlapped rollout and the card's actor at 64 rows, are not.
CONFIG_64ENV = ROOT / "configs" / "car_racer_64env.yaml"
LEG_64ENV = ("env.env_id=fake", "train.buffer_size=12800", "train.random_iterations=1",
             "train.eval_every=2", "train.checkpoint_every=2", "train.eval_episodes=2",
             "train.final_eval_episodes=2")
ITERATIONS_64ENV = (2, 3)
VARIANTS_64ENV = (("host_actor", (), 2, True),
                  ("overlapped", ("runtime.async_rollout=true",), 2, False),
                  ("card_actor", ("runtime.rollout_device=default",), 2, False))
EVAL_64ENV_STEPS = (10, 20)
# Timed policy_act_observe steps of the host actor at each thread count.
HOST_ACTOR_STEPS = 5


def fail(msg: str) -> None:
    print(f"FAILED: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls (CUDA events)."""
    import torch

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


def bound_ms(nbytes: float, flops: float, f32_flops: float = 0.0):
    """The least time for the work: bytes over the memory rate against bf16
    operations over the tensor-core rate plus f32 operations over the f32
    rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (flops / BF16_FLOP_PER_S + f32_flops / F32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(out, ref, tolerance, name: str) -> float:
    """Max |out - ref|; fails unless every element is within
    ``tolerance(ref)``.  Prints the error beside the tolerance and the
    reference's rms and max, so that a reader sees the tolerance is below the
    size of what it compares."""
    import torch

    out, ref = out.detach().float(), ref.detach().float()
    if out.shape != ref.shape:
        fail(f"{name}: shape {tuple(out.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(out).all():
        fail(f"{name}: non-finite output")
    if not ref.any():
        fail(f"{name}: the reference is all zero, so the check compares nothing")
    diff = (out - ref).abs()
    tol = tolerance(ref)
    worst = float(diff.max())
    line = (f"{name}: max_abs_err={worst:.3e} tol<={float(tol.max()):.3e} "
            f"ref_rms={float(ref.square().mean().sqrt()):.3e} "
            f"ref_max={float(ref.abs().max()):.3e}")
    if bool((diff > tol).any()):
        fail(f"{line}: over the tolerance")
    print(line, flush=True)
    return worst


def draw_zero_params(modules, gen) -> None:
    """Every all-zero parameter of ``modules`` ~ N(0, ZERO_INIT_STD) in place,
    in the modules' parameter order, from the CPU generator ``gen``."""
    import torch

    with torch.no_grad():
        for m in modules:
            for p in m.parameters():
                if not p.any():
                    p.copy_(ZERO_INIT_STD * torch.randn(p.shape, generator=gen))


def check_gru(cfg, card: str) -> dict:
    """The GRU cell kernel at serving's 1 and 64 rows, the learner's 50 and
    the 1500 of hold_observe against its plain version; CUDA-event times
    beside the plain version's and torch.gru_cell's, the profiler's device
    time per launch of both (CUDA events time the host's launch at few
    rows), the plan's blocks and the tensor-core instructions in its SASS."""
    import torch

    from dreamer_tpu_torch.nets.gru import GRUCell
    from dreamer_tpu_torch.ops.gru_cuda import gru_cell, gru_cell_plain, gru_plan, tolerance

    hmma = sass_hmma("gru_cell_kernel")
    print("kernels: gru_cell SASS tensor-core instructions per instantiation: "
          + ", ".join(f"{k} {v}" for k, v in hmma.items()), flush=True)
    if not hmma or not all(hmma.values()):
        fail(f"gru_cell: an instantiation of gru_cell_kernel has no HMMA: {hmma}")
    H = cfg.wm.hidden_dim
    I = cfg.wm.latent_dim + cfg.env.action_dim
    gen = torch.Generator().manual_seed(1)
    cell = GRUCell(I, H, torch.bfloat16, gen).cuda()
    wi_t, wh_t, bi, bh = cell.kernel_weights()
    # The library yardstick: torch.gru_cell has the same semantics.
    w_ih = cell.kernel_i.detach().t().contiguous().to(torch.bfloat16)
    w_hh = cell.kernel_h.detach().t().contiguous().to(torch.bfloat16)
    b_ih = cell.bias_i.detach().to(torch.bfloat16)
    b_hh = cell.bias_h.detach().to(torch.bfloat16)
    worst, times = 0.0, {}
    for n in (1, 50, 64, 1500):
        x = torch.randn(n, I, generator=gen).to("cuda", torch.bfloat16)
        h = torch.randn(n, H, generator=gen).clamp(-1, 1).to("cuda", torch.bfloat16)
        out = gru_cell(x, h, wi_t, wh_t, bi, bh)
        torch.cuda.synchronize()
        ref = gru_cell_plain(x, h, wi_t, wh_t, bi, bh)
        worst = max(worst, max_err(out, ref, tolerance, f"kernels: gru_cell N={n}"))
        kernel = lambda: gru_cell(x, h, wi_t, wh_t, bi, bh)  # noqa: E731
        library = lambda: torch.gru_cell(x, h, w_ih, w_hh, b_ih, b_hh)  # noqa: E731
        t = {"ms": cuda_ms(kernel, 200),
             "plain_ms": cuda_ms(lambda: gru_cell_plain(x, h, wi_t, wh_t, bi, bh), 200),
             "library_ms": cuda_ms(library, 200)}
        dev = device_ms(kernel, "gru_cell_kernel", 1)
        t["device_ms"] = dev[0] if dev else None
        t["library_device_ms"] = device_total_ms(library)
        # x, h and the out in bf16; the unpadded gate weights (I + H, 3H)
        # and the biases, which the flax cell rounds to bf16.
        nbytes = 2 * (n * I + n * H + 3 * H * (I + H) + n * H) + 2 * 6 * H
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, 2 * n * 3 * H * (I + H))
        times[n] = t
        plan = gru_plan(n, 1, I, H)
        print(f"kernels: gru_cell N={n} kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
              f"library_ms={t['library_ms']:.4f} (torch.gru_cell) bound_ms={t['bound_ms']:.4f} "
              f"({t['bound_by']}); device time per launch (profiler) kernel {fmt_ms(dev and dev[0])}"
              f" ms, torch.gru_cell {fmt_ms(t['library_device_ms'])} ms; {plan.row_blocks} x "
              f"{plan.col_blocks} blocks of {plan.threads} threads ({plan.bm} x {plan.j} tiles, "
              f"{plan.smem} B smem) on {card}", flush=True)
    n_ac = cfg.train.batch_size
    if not (times[n_ac]["device_ms"] and times[n_ac]["library_device_ms"]):
        print("kernels: gru_cell: the profiler saw no device time at the path's rows: not "
              "measured", flush=True)
    # The line's times are at the AC path's shape: the warm start's 50 rows.
    line = {"name": "gru_cell", "route": "cuda", "source": "dreamer_tpu_torch/csrc/gru_cell.cu",
            "replaces": "dreamer_tpu/ops/gru_pallas.py:111", "max_abs_err": worst,
            **times[n_ac], "sass_hmma": sum(hmma.values())}
    for n in (1, 64, 1500):
        for k in ("ms", "library_ms", "device_ms", "library_device_ms", "bound_ms"):
            line[f"{k}_at_{n}"] = times[n][k]
    return line


def check_gru_scan(cfg, card: str) -> dict:
    """The whole-scan GRU at T 30 x B 50 (the TPU kernel's own form) and at
    the world-model path's form, T 1 over the 30 x 50 pre-step states: all
    five outputs against the plain version; the T 30 launch relaunched at
    T = 1 from its own states, equal bit for bit (``hold_scan``); times
    beside cuDNN's GRU over the same x and h0 (h_seq only, no residuals)."""
    import torch

    from dreamer_tpu_torch.nets.gru import GRUCell
    from dreamer_tpu_torch.ops import gru_scan_cuda as gs
    from dreamer_tpu_torch.ops.gru_cuda import gru_cell, gru_plan

    hmma = sass_hmma("gru_scan_kernel")
    print("kernels: gru_scan SASS tensor-core instructions per instantiation: "
          + ", ".join(f"{k} {v}" for k, v in hmma.items()), flush=True)
    if not hmma or not all(hmma.values()):
        fail(f"gru_scan: an instantiation of gru_scan_kernel has no HMMA: {hmma}")
    H = cfg.wm.hidden_dim
    I = cfg.wm.latent_dim + cfg.env.action_dim
    B, T = cfg.train.batch_size, cfg.train.horizon
    gen = torch.Generator().manual_seed(11)
    cell = GRUCell(I, H, torch.bfloat16, gen).cuda()
    ops = cell.kernel_weights()
    lib_gru = torch.nn.GRU(I, H).to("cuda", torch.bfloat16)
    with torch.no_grad():
        lib_gru.weight_ih_l0.copy_(ops[0][:, :I])
        lib_gru.weight_hh_l0.copy_(ops[1][:, :H])
        lib_gru.bias_ih_l0.copy_(ops[2])
        lib_gru.bias_hh_l0.copy_(ops[3])
    lib_gru.flatten_parameters()
    worst, times = 0.0, {}
    for t, b in ((T, B), (1, T * B)):
        xs = torch.randn(t, b, I, generator=gen).to("cuda", torch.bfloat16)
        # The path's h0 are bf16-valued states: the forward rounds them.
        h0 = torch.randn(b, H, generator=gen).clamp(-1, 1).to(torch.bfloat16).float().cuda()
        out = gs.gru_scan(xs, h0, *ops)
        torch.cuda.synchronize()
        stats = gs.compare(out, gs.gru_scan_plain(xs, h0, *ops))
        if t > 1:
            held = gs.hold_scan(out, xs, h0, ops)
            stats["failures"] += held["failures"]
            carry = (f"; the launch relaunched at T = 1 from its own {t * b} states differs "
                     f"bit for bit in {int(held['carry_mismatches'])} (step, row) pairs")
        else:
            # One step on bf16-valued states sums as the GRU cell kernel does:
            # one K schedule, and the h_lo half is zero.  The posterior
            # scan's backward rests on it.
            same = gru_cell(xs[0], h0.to(torch.bfloat16), *ops)
            cell_diff = int((out[0][0].to(torch.bfloat16) != same).sum())
            carry = (f"; h' rounded to bf16 differs from the GRU cell kernel's output in "
                     f"{cell_diff} of {same.numel()} elements (gated: 0)")
            if cell_diff:
                stats["failures"].append(f"the T = 1 step differs from the GRU cell kernel in "
                                         f"{cell_diff} elements")
        errs = " ".join(f"{n} {stats[f'max_abs_err_{n}']:.3e}" for n in gs.NAMES)
        print(f"kernels: gru_scan T={t} B={b}: max |kernel - plain| {errs} "
              f"(tol {gs.TOL} abs + rel){carry}", flush=True)
        if stats["failures"]:
            fail(f"gru_scan T={t} B={b}: {stats['failures']}")
        worst = max([worst] + [stats[f"max_abs_err_{n}"] for n in gs.NAMES])
        with torch.no_grad():
            h16 = h0.to(torch.bfloat16)[None]
            kernel = lambda: gs.gru_scan(xs, h0, *ops)  # noqa: E731
            tm = {"ms": cuda_ms(kernel, 20),
                  "plain_ms": cuda_ms(lambda: gs.gru_scan_plain(xs, h0, *ops), 5, 1)}
            dev = device_ms(kernel, "gru_scan_kernel", 1, reps=5 if t > 1 else 20)
            tm["device_ms"] = dev[0] if dev else None
            try:  # the yardstick only: the port never calls it
                tm["library_ms"] = cuda_ms(lambda: lib_gru(xs, h16), 20)
            except RuntimeError as e:
                print(f"kernels: gru_scan: cuDNN's bf16 GRU did not run ({e}): library_ms "
                      "null", flush=True)
                tm["library_ms"] = None
        nbytes, ops_bf16 = gs.bound_numbers(t, b, I, H)
        tm["bound_ms"], tm["bound_by"] = bound_ms(nbytes, ops_bf16)
        # PR 6's bound, for the record: the h products counted once, at the
        # f32 rate outside the tensor cores, as that kernel did them.
        h_ops = 2.0 * t * b * 3 * H * H
        old_bound = bound_ms(nbytes, ops_bf16 - 2 * h_ops, h_ops)[0]
        times[(t, b)] = tm
        plan = gru_plan(b, t, I, H, scan=True)
        print(f"kernels: gru_scan T={t} B={b} kernel_ms={tm['ms']:.4f} "
              f"plain_ms={tm['plain_ms']:.4f} library_ms={tm['library_ms']} "
              f"(cuDNN torch.nn.GRU, h_seq only) bound_ms={tm['bound_ms']:.4f} "
              f"({tm['bound_by']}: {nbytes / 1e6:.2f} MB, {ops_bf16 / 1e9:.2f} GFLOP bf16 with "
              f"both halves of h; PR 6's bound with the h part at the f32 rate "
              f"{old_bound:.4f}); device time (profiler) {fmt_ms(tm['device_ms'])} ms; "
              f"{plan.row_blocks} x {plan.col_blocks} blocks of {plan.threads} threads "
              f"({plan.bm} x {plan.j} tiles, {plan.col_steps} column groups a step, "
              f"{plan.smem} B smem) on {card}", flush=True)
    # The line's times are at the world-model path's form.
    return {"name": "gru_scan", "route": "cuda", "source": "dreamer_tpu_torch/csrc/gru_scan.cu",
            "replaces": "dreamer_tpu/ops/gru_pallas.py:223", "max_abs_err": worst,
            **times[(1, T * B)],
            "ms_at_T30_B50": times[(T, B)]["ms"], "plain_ms_at_T30_B50": times[(T, B)]["plain_ms"],
            "library_ms_at_T30_B50": times[(T, B)]["library_ms"],
            "device_ms_at_T30_B50": times[(T, B)]["device_ms"],
            "bound_ms_at_T30_B50": times[(T, B)]["bound_ms"], "sass_hmma": sum(hmma.values())}


def sass_hmma(kernel: str) -> dict:
    """HMMA (and HGMMA) instructions in each instantiation of the kernel
    whose name holds ``kernel`` in the built library, read with the
    toolkit's cuobjdump -sass; keyed by its template arguments."""
    from dreamer_tpu_torch.ops import cuda_build

    cuobjdump = Path(cuda_build.nvcc_path()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(cuda_build.build())],
                          capture_output=True, text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            if kernel not in fn:
                fn = None
                continue
            args = re.findall(r"Li(\d+)E", fn)
            fn = f"<{','.join(args)}>" if args else fn
            counts[fn] = 0
        elif fn and re.search(r"\bH(G)?MMA\b", line):
            counts[fn] += 1
    return counts


def fmt_ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f}"


def _device_events(fn, reps: int):
    """The device kernels of 1 + ``reps`` calls of ``fn`` under
    torch.profiler, in start order.  The profiler may miss the first
    kernel of a window, so the first call is there to be dropped."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps + 1):
            fn()
        torch.cuda.synchronize()
    return sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)


def device_total_ms(fn, reps: int = 20):
    """Device time per call of ``fn``, all its kernels summed over the last
    ``reps`` calls (torch.profiler), or None if the profiler saw none."""
    events = _device_events(fn, reps)
    per_call = -(-len(events) // (reps + 1))
    if not events or len(events) < reps * per_call:
        return None
    return sum(e.device_time_total for e in events[-reps * per_call:]) / reps / 1e3


def device_ms(fn, kernel: str, per_call: int, reps: int = 20):
    """Device time per call of ``fn`` of each of the ``per_call`` launches
    of the kernels whose name holds ``kernel``, in launch order, over the
    last ``reps`` calls (torch.profiler), or None if the profiler saw fewer:
    where back-to-back calls are bound by the host's launches, CUDA events
    time the host."""
    events = [e for e in _device_events(fn, reps) if kernel in e.name]
    if len(events) < per_call * reps:
        print(f"device_ms: the profiler saw {len(events)} launches of {kernel}, expected "
              f"{per_call * reps} or more", flush=True)
        return None
    events = events[-per_call * reps:]
    return [sum(e.device_time_total for e in events[i::per_call]) / reps / 1e3
            for i in range(per_call)]


def check_encoder(cfg, card: str) -> dict:
    """The encoder kernel at serving's 1, 50 and 64 frames and the learner's
    1250 and 1500 against its plain version; times at 1, 64, 1250 and 1500
    beside cuDNN's (NCHW and channels_last, the faster kept), the launch
    geometry, and the tensor-core instructions in its SASS."""
    import torch
    import torch.nn.functional as F

    from dreamer_tpu_torch.nets.wm_nets import WMNets
    from dreamer_tpu_torch.ops.conv_cuda import (encoder_forward, encoder_forward_plain,
                                                 encoder_plan, tolerance)

    hmma = sass_hmma("encoder_conv_kernel")
    print("kernels: encoder SASS tensor-core instructions per instantiation (MT, NT): "
          + ", ".join(f"{k} {v}" for k, v in hmma.items()), flush=True)
    if not hmma or not all(hmma.values()):
        fail(f"encoder: an instantiation of encoder_conv_kernel has no HMMA: {hmma}")
    gen = torch.Generator().manual_seed(2)
    nets = WMNets(cfg.wm, cfg.env.action_dim, torch.bfloat16, gen)
    draw_zero_params([nets], gen)
    nets = nets.cuda()
    ws, bs = nets.encoder_weights()
    tables = {"serve": nets.serve_norm, "train": nets.train_norm}
    oihw = [c.weight.detach().to(torch.bfloat16) for c in nets.enc_convs]
    bias16 = [c.bias.detach().to(torch.bfloat16) for c in nets.enc_convs]
    Hf, Wf = cfg.wm.obs_size
    chans = tuple(w.shape[3] for w in ws)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # Serving's 1 and 64 envs (serving's table), the AC path's B x Tw frames of
    # a warm start and the WM update's B x horizon frames (the training
    # table; the 1500 frames also under serving's, so that each table is held
    # at the path's largest shape).
    n_ac = cfg.train.batch_size * (cfg.train.sequence_length // 2)
    n_wm = cfg.train.batch_size * cfg.train.horizon
    worst, times = 0.0, {}
    for n, rounding in ((1, "serve"), (50, "serve"), (64, "serve"), (n_ac, "train"),
                        (n_wm, "serve"), (n_wm, "train")):
        table = tables[rounding]
        obs = torch.randint(0, 256, (n, Hf, Wf, 3), dtype=torch.uint8, generator=gen).cuda()
        out = encoder_forward(obs, ws, bs, table)
        torch.cuda.synchronize()
        ref = encoder_forward_plain(obs, ws, bs, table)
        worst = max(worst, max_err(out, ref, tolerance,
                                   f"kernels: encoder N={n} ({rounding} table)"))
        if n != 50 and (n, rounding) != (n_wm, "serve"):
            def library(fmt):
                # The cuDNN yardstick: four bf16 conv2d + SiLU, NHWC out.
                wf = [w.contiguous(memory_format=fmt) for w in oihw]

                def run():
                    x = table[obs.long()].permute(0, 3, 1, 2).contiguous(memory_format=fmt)
                    for w, b in zip(wf, bias16):
                        x = F.silu(F.conv2d(x, w, b, stride=2, padding=1))
                    return x.permute(0, 2, 3, 1).reshape(n, -1)
                return run

            t = {"ms": cuda_ms(lambda: encoder_forward(obs, ws, bs, table), 20),
                 "plain_ms": cuda_ms(lambda: encoder_forward_plain(obs, ws, bs, table), 20)}
            lib = {name: cuda_ms(library(fmt), 20) for name, fmt in (
                ("NCHW", torch.contiguous_format), ("channels_last", torch.channels_last))}
            t["library_ms"] = min(lib.values())
            layers = device_ms(lambda: encoder_forward(obs, ws, bs, table),
                               "encoder_conv_kernel", 4)
            dev = sum(layers) if layers else None
            flops, cin, hw = 0, 3, Hf * Wf
            for w in ws:
                hw //= 4
                flops += 2 * n * hw * w.shape[3] * 16 * cin
                cin = w.shape[3]
            nbytes = obs.numel() + 2 * (sum(w.numel() for w in ws) + out.numel() + 256) \
                + 4 * sum(b.numel() for b in bs)
            t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
            times[n] = t
            plan = encoder_plan(n, Hf, Wf, chans, sms)
            print(f"kernels: encoder N={n} kernel_ms={t['ms']:.4f} "
                  f"({flops / t['ms'] / 1e9:.1f} TFLOP/s) plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']:.4f} (cuDNN NCHW {lib['NCHW']:.4f}, "
                  f"channels_last {lib['channels_last']:.4f}) bound_ms={t['bound_ms']:.4f} "
                  f"({t['bound_by']}); device time (profiler) {dev} ms, by layer "
                  + (" ".join(f"{x:.4f}" for x in layers) if layers else "not measured")
                  + f" on {card}", flush=True)
            t["device_ms"] = dev
            print(f"kernels: encoder N={n} grid: 4 launches of 256 threads, blocks "
                  + ", ".join(f"L{l} {p.blocks} ({p.bm}x{p.bn} tile, MT={p.mt} NT={p.nt}, "
                              f"{p.g} frame{'s' if p.g > 1 else ''}/block, "
                              f"{p.smem} B smem)" for l, p in enumerate(plan))
                  + f" on {sms} SMs", flush=True)
    # The line's times are at the world-model update's shape.
    return {"name": "encoder", "route": "cuda", "source": "dreamer_tpu_torch/csrc/encoder.cu",
            "replaces": "dreamer_tpu/ops/conv_pallas.py:144", "max_abs_err": worst,
            **times[n_wm], "ms_at_1250": times[n_ac]["ms"],
            "library_ms_at_1250": times[n_ac]["library_ms"],
            "ms_at_1": times[1]["ms"], "library_ms_at_1": times[1]["library_ms"],
            "device_ms_at_1": times[1]["device_ms"],
            "ms_at_64": times[64]["ms"], "library_ms_at_64": times[64]["library_ms"],
            "device_ms_at_64": times[64]["device_ms"],
            "sass_hmma": sum(hmma.values())}


def run_policy(policy, cfg, card: str) -> None:
    """The main path: Policy's serving programs on the card."""
    import torch

    from dreamer_tpu_torch.ops.conv_cuda import encoder_forward
    from dreamer_tpu_torch.ops.gru_cuda import gru_cell

    c = cfg.wm
    for n in (1, 64):
        gen = torch.Generator(device="cuda").manual_seed(100 + n)
        frames = torch.randint(0, 256, (POLICY_STEPS + 1, n, *c.obs_size, 3),
                               dtype=torch.uint8, device="cuda", generator=gen)
        h, z = policy.policy_reset(frames[0], policy.sample_noise(n, gen).gumbel_obs)
        action = torch.zeros(n, cfg.env.action_dim, device="cuda")
        for t in range(1, POLICY_STEPS + 1):
            if t == WARMUP_STEPS + 1:
                torch.cuda.synchronize()
                start = time.perf_counter()
            before = (gru_cell.launches, encoder_forward.launches)
            done = torch.zeros(n, dtype=torch.bool, device="cuda")
            done[0] = t == RESET_STEP
            h, z, action = policy.policy_act_observe(h, z, action, frames[t], done,
                                                     policy.sample_noise(n, gen))
            if (gru_cell.launches - before[0], encoder_forward.launches - before[1]) != (1, 1):
                fail(f"policy N={n} step {t}: the step did not launch each kernel once")
        torch.cuda.synchronize()
        steps = POLICY_STEPS - WARMUP_STEPS
        elapsed = time.perf_counter() - start
        for name, v, shape in (("h", h, (n, c.hidden_dim)), ("z", z, (n, c.latent_dim)),
                               ("action", action, (n, cfg.env.action_dim))):
            if tuple(v.shape) != shape or not torch.isfinite(v).all():
                fail(f"policy N={n}: {name} is {tuple(v.shape)} or not finite")
        if action.abs().max() > 1.0:
            fail(f"policy N={n}: action outside [-1, 1]")
        # z is the straight-through sample onehot + p - p: within f32 rounding
        # of 0 or 1, with exactly one entry near 1 in each row.
        rows = z.view(n, c.latent_rows, -1)
        if (rows - rows.round()).abs().max() > 1e-5 or not bool(((rows > 0.5).sum(-1) == 1).all()):
            fail(f"policy N={n}: z rows are not one-hot")
        print(f"policy: N={n} {POLICY_STEPS} policy_act_observe steps (reset row at step "
              f"{RESET_STEP}); after {WARMUP_STEPS} warm-up steps "
              f"{1e3 * elapsed / steps:.3f} ms/step, {steps / elapsed:.1f} steps/s, "
              f"{steps * n / elapsed:.1f} env-steps/s on {card}", flush=True)


def profile_policy(policy, cfg, card: str) -> None:
    """Where a step's time goes: torch.profiler over PROFILE_STEPS steps, the
    kernels' summed device time against the host's wall clock."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    c = cfg.wm
    for n in (1, 64):
        gen = torch.Generator(device="cuda").manual_seed(200 + n)
        obs = torch.randint(0, 256, (n, *c.obs_size, 3), dtype=torch.uint8, device="cuda",
                            generator=gen)
        h, z = policy.policy_reset(obs, policy.sample_noise(n, gen).gumbel_obs)
        action = torch.zeros(n, cfg.env.action_dim, device="cuda")
        done = torch.zeros(n, dtype=torch.bool, device="cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            start = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                h, z, action = policy.policy_act_observe(h, z, action, obs, done,
                                                         policy.sample_noise(n, gen))
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - start) * 1e6
        # Only the device's own events (kernels, copies): an operator's row
        # repeats the device time of the kernels it launched.
        per_kernel = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(d for d, _, _ in per_kernel)
        if busy == 0:
            print(f"profile: N={n} torch.profiler saw no device time: not measured", flush=True)
            continue
        launches = sum(cnt for _, cnt, _ in per_kernel)
        print(f"profile: N={n} {PROFILE_STEPS} steps: device busy {busy / PROFILE_STEPS:.1f} "
              f"us/step of {wall_us / PROFILE_STEPS:.1f} us/step wall "
              f"({100 * busy / wall_us:.1f}% busy; the profiler slows the host), "
              f"{launches / PROFILE_STEPS:.1f} device kernels/step, on {card}", flush=True)
        for dev, cnt, key in sorted(per_kernel, reverse=True)[:6]:
            print(f"profile: N={n}   {dev / PROFILE_STEPS:8.1f} us/step  x{cnt / PROFILE_STEPS:g}"
                  f"  {key[:90]}", flush=True)


def check_policy_vs_cpu(cfg) -> None:
    """One step on the card against the same step on the CPU (plain versions),
    from the same weights, state, frame and noise: h' through the GRU, and the
    deterministic action from a fixed (h, z)."""
    import torch

    from dreamer_tpu_torch.ops import conv_cuda, gru_cuda
    from dreamer_tpu_torch.train import Policy

    gpu, cpu = Policy(cfg, seed=0), Policy(cfg, device="cpu", seed=0)
    for p in (gpu, cpu):
        draw_zero_params([p.rssm.nets, p.actor], torch.Generator().manual_seed(8))
    c, n = cfg.wm, 4
    gen = torch.Generator().manual_seed(7)
    obs = torch.randint(0, 256, (n, *c.obs_size, 3), dtype=torch.uint8, generator=gen)
    h = torch.randn(n, c.hidden_dim, generator=gen).clamp(-1, 1)
    z = torch.nn.functional.one_hot(torch.randint(0, c.latent_classes, (n, c.latent_rows),
                                                  generator=gen), c.latent_classes)
    z = z.float().reshape(n, -1)
    a = torch.rand(n, cfg.env.action_dim, generator=gen) * 2 - 1
    noise = cpu.sample_noise(n, gen)
    out_cpu = cpu.policy_act_observe(h, z, a, obs, torch.zeros(n, dtype=torch.bool), noise)
    out_gpu = gpu.policy_act_observe(*(t.cuda() for t in (h, z, a, obs)),
                                     torch.zeros(n, dtype=torch.bool, device="cuda"),
                                     type(noise)(*(t.cuda() for t in noise)))
    # h' comes out of the GRU kernel and the action from h through the
    # actor, both |v| <= 1: the GRU's tolerance for both.
    max_err(out_gpu[0].cpu(), out_cpu[0], gru_cuda.tolerance,
            f"policy: card vs cpu plain, one step N={n}, h'")
    act_cpu = cpu.policy_act(h, z, deterministic=True)
    act_gpu = gpu.policy_act(h.cuda(), z.cuda(), deterministic=True)
    max_err(act_gpu.cpu(), act_cpu, gru_cuda.tolerance,
            f"policy: card vs cpu plain, N={n}, deterministic action")
    max_err(gpu.rssm.encode_obs(obs.cuda()).cpu(), cpu.rssm.encode_obs(obs),
            conv_cuda.tolerance, f"policy: card vs cpu plain, N={n}, features")


def imagine_setup(cfg, prior_scale: float = 1.0):
    """Seeded flagship world model and actor (every all-zero parameter drawn),
    their imagine-kernel operands, and a start state and noise for B x T."""
    import torch

    from dreamer_tpu_torch.core.dists import sample_gumbel
    from dreamer_tpu_torch.nets import Actor, WMNets

    c, a = cfg.wm, cfg.agent
    gen = torch.Generator().manual_seed(3)
    nets = WMNets(c, cfg.env.action_dim, torch.bfloat16, gen)
    actor = Actor(c.hidden_dim + c.latent_dim, cfg.env.action_dim, a.actor_hidden_1,
                  a.actor_hidden_2, a.min_std, torch.bfloat16, gen)
    draw_zero_params([nets, actor], gen)
    with torch.no_grad():
        nets.dyn_head.denses[2].weight.mul_(prior_scale)
    nets.cuda()
    actor.cuda()
    weights = [*actor.imagine_weights(), *nets.imagine_weights()]
    B, T = cfg.train.batch_size, cfg.train.horizon
    h0 = torch.randn(B, c.hidden_dim, generator=gen).tanh().cuda()
    z0 = torch.nn.functional.one_hot(torch.randint(0, c.latent_classes, (B, c.latent_rows),
                                                   generator=gen), c.latent_classes)
    z0 = z0.float().reshape(B, -1).cuda()
    g = torch.Generator(device="cuda").manual_seed(4)
    eps = torch.randn(T, B, cfg.env.action_dim, generator=g, device="cuda")
    gum = sample_gumbel((T, B, c.latent_rows, c.latent_classes), g, "cuda")
    return weights, h0, z0, eps, gum


def report_hold(stats: dict, label: str) -> dict:
    """Print one per-step check of the imagine kernel (``imagine_cuda.
    hold_steps`` or ``hold_rollout``) and fail on what it found."""
    from dreamer_tpu_torch.ops import imagine_cuda as ic

    carry = (f"; relaunched steps differing from the rollout bit for bit "
             f"{int(stats['carry_mismatches'])}" if "carry_mismatches" in stats else "")
    print(f"imagine: per step ({label}): {int(stats['rows'])} latent rows, max |kernel - plain| "
          f"h' {stats['max_abs_err_h_next']:.3e} mu {stats['max_abs_err_mu']:.3e} "
          f"sigma {stats['max_abs_err_sigma']:.3e} action {stats['max_abs_err_action']:.3e} "
          f"(tol {ic.TOL} abs + rel); near ties (top-two score gap < {ic.NEAR_TIE}) "
          f"{int(stats['near_ties'])}, flipped there {int(stats['flips'])}, flipped elsewhere "
          f"{int(stats['flips_not_near_tie'])}; straight-through values max err "
          f"{stats['max_abs_err_z_hot']:.3e}, residual share {stats['residual_share']:.3f}"
          f"{carry}", flush=True)
    if stats["failures"]:
        fail(f"imagine per step ({label}): {stats['failures']}")
    return stats


def check_imagine(cfg, card: str) -> dict:
    """The kernel at B 50, T 30, at the init's nearly flat prior and at a
    peaked one: each whole-rollout launch held step by step
    (``hold_rollout``: relaunched at T = 1 from its own states, equal bit
    for bit, and held to the plain step), and the plain rollout's states as
    one T = 1 launch over 1500 rows (``hold_steps``); the same at the
    drone's widths (configs/drone.yaml, B 128); times at B 50 x T 30, at
    T 1 x 1500 rows and at the drone's B 128 x T 30; at each, from one
    launch's record, the blocks that ran, the SMs they ran on (at least
    MIN_IMAGINE_SMS) and the grid barriers they crossed (the plan's
    BARRIERS_PER_STEP a step); the tensor-core instructions in the kernel's
    SASS."""
    import torch

    from dreamer_tpu_torch.config import DreamerConfig
    from dreamer_tpu_torch.ops import imagine_cuda as ic

    hmma = sass_hmma("imagine_kernel")
    print("kernels: imagine SASS tensor-core instructions: "
          + ", ".join(f"{k} {v}" for k, v in hmma.items()), flush=True)
    if not hmma or not all(hmma.values()):
        fail(f"imagine: the imagine_kernel SASS has no HMMA: {hmma}")
    held, timed = [], {}
    drone = DreamerConfig.from_yaml(str(DRONE))
    for name, conf, scales in (("flagship", cfg, (1.0, PEAKED_PRIOR)), ("drone", drone, (1.0,))):
        c, a = conf.wm, conf.agent
        for scale in scales:
            weights, h0, z0, eps, gum = imagine_setup(conf, scale)
            T, B, A = eps.shape
            out = ic.imagine_rollout(h0, z0, eps, gum, weights, c.unimix, a.min_std)
            torch.cuda.synchronize()
            shapes = [(B, c.hidden_dim), (B, c.latent_dim), (T, B, c.hidden_dim),
                      (T, B, c.latent_dim), (T, B, A), (T, B, A), (T, B, A)]
            for key, o, shape in zip(ic.NAMES, out, shapes):
                if tuple(o.shape) != shape or not bool(torch.isfinite(o).all()):
                    fail(f"imagine {name}: {key} is {tuple(o.shape)} or not finite")
            if out[4].abs().max() > 1.0:
                fail(f"imagine {name}: action outside [-1, 1]")
            one_hot_rows(out[3].reshape(T * B, -1), c, f"imagine {name}: z_seq")
            ref = ic.imagine_rollout_plain(h0, z0, eps, gum, weights, c.unimix, a.min_std)
            plain = ic.hold_steps(ref[2], ref[3], eps, gum, weights, c.unimix, a.min_std)[0]
            prior = (f"{name} widths, prior output x {scale:g}, mean top prior probability "
                     f"{plain['mean_top_prob']:.3f}")
            agree = ic.rollout_agreement(out, ref, c.latent_rows, c.latent_classes)
            print(f"imagine: whole rollout B={B} T={T} ({prior}), kernel vs plain: first step "
                  f"whose categories differ {agree['first_step_differs']} (-1: none), equal "
                  f"categories {agree['equal_share']:.5f}", flush=True)
            held.append(report_hold(ic.hold_rollout(out, eps, gum, weights, c.unimix, a.min_std),
                                    f"the kernel's B={B} T={T} rollout; {prior}"))
            held.append(report_hold(plain, f"the plain rollout's states; {prior}"))
            if scale == 1.0:
                timed[name] = weights, h0, z0, eps, gum, c, a
    worst = max(s[f"max_abs_err_{k}"] for s in held for k in ("h_next", "mu", "sigma", "action"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    line = {}
    # The learner's form (B 50 x T 30), hold_steps' form (T 1 over its 1500
    # rows) and the drone's (B 128 x T 30).
    for form in ("path", "T1", "drone"):
        weights, h0, z0, eps, gum, c, a = timed["drone" if form == "drone" else "flagship"]
        if form == "T1":
            T, B = eps.shape[:2]
            gen = torch.Generator(device="cuda").manual_seed(21)
            h0 = torch.randn(T * B, h0.shape[1], generator=gen, device="cuda").tanh()
            z0 = z0.repeat(T, 1)
            eps, gum = eps.reshape(1, T * B, -1), gum.reshape(1, T * B, *gum.shape[2:])
        T, B = eps.shape[:2]
        kernel = lambda: ic.imagine_rollout(h0, z0, eps, gum, weights, c.unimix,  # noqa: E731
                                            a.min_std)
        t = {"ms": cuda_ms(kernel, 20),
             "plain_ms": cuda_ms(lambda: ic.imagine_rollout_plain(h0, z0, eps, gum, weights,
                                                                  c.unimix, a.min_std),
                                 5 if T > 1 else 20, 1),
             "library_ms": None}
        dev = device_ms(kernel, "imagine_kernel", 1, reps=10)
        t["device_ms"] = dev[0] if dev else None
        dims = ic.dims_of(weights, h0, z0, eps)
        nbytes, flops = ic.bound_numbers(B, T, weights, dims)
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
        plan = ic.imagine_plan(ic.widths_of(dims, c.latent_rows, c.latent_classes), sms)
        rec = ic.launch_record(ic._launch(h0, z0, eps, gum, weights, c.unimix, a.min_std,
                                          sms)[1])
        t["blocks"], t["sms"] = rec["blocks"], rec["sms"]
        t["barriers_per_step"] = rec["barriers"] / T
        print(f"imagine: {form} B={B} T={T} kernel_ms={t['ms']:.4f} (device "
              f"{fmt_ms(t['device_ms'])}) plain_ms={t['plain_ms']:.4f} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}: {nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.2f} GFLOP) library_ms=null; one cooperative launch: "
              f"{rec['blocks']} blocks of {ic.THREADS} threads ran on {rec['sms']} of {sms} "
              f"SMs and crossed {t['barriers_per_step']:g} grid barriers a step (its "
              f"record), weights {'resident' if plan.stationary else 'streamed'} "
              f"({plan.weight_bytes} B of {plan.smem} B smem a block) on {card}", flush=True)
        if (rec["blocks"] != plan.blocks or rec["sms"] < MIN_IMAGINE_SMS
                or rec["count"] != plan.blocks * ic.BARRIERS_PER_STEP * T):
            fail(f"imagine {form}: the launch's record {rec} is not {plan.blocks} blocks on at "
                 f"least {MIN_IMAGINE_SMS} SMs through {ic.BARRIERS_PER_STEP} barriers a step")
        line[form] = t
    # The line's times are at the learner's form, B 50 x T 30.
    out = {"name": "imagine_rollout", "route": "cuda",
           "source": "dreamer_tpu_torch/csrc/imagine.cu",
           "replaces": "dreamer_tpu/ops/imagine_pallas.py:334", "max_abs_err": worst,
           **line["path"], "sass_hmma": sum(hmma.values())}
    for form, key in (("T1", "T1_B1500"), ("drone", "drone_B128_T30")):
        for k in ("ms", "device_ms", "plain_ms", "bound_ms"):
            out[f"{k}_at_{key}"] = line[form][k]
    return out


def one_hot_rows(z, c, name: str) -> None:
    """Every latent row of z (N, rows*classes) within 1e-5 of 0 or 1 with
    exactly one entry above 0.5: the straight-through sample's value."""
    rows = z.reshape(z.shape[0], c.latent_rows, -1)
    if (rows - rows.round()).abs().max() > 1e-5 or not bool(((rows > 0.5).sum(-1) == 1).all()):
        fail(f"{name}: rows are not one-hot")


def flagship_trainer(cfg, device=None):
    """The flagship Trainer with a ring of AC_RING random steps."""
    import torch

    from dreamer_tpu_torch.train import Trainer

    cfg = copy.deepcopy(cfg)
    cfg.train.buffer_size = AC_RING
    trainer = Trainer(cfg, device=device, seed=0)
    gen = torch.Generator().manual_seed(5)
    ring = trainer.buffer.init_state(trainer.device)
    n = AC_RING
    trainer.buffer.add_batch(
        ring, torch.randint(0, 256, (1, n, *cfg.wm.obs_size, 3), dtype=torch.uint8,
                            generator=gen).to(trainer.device),
        (torch.rand(1, n, cfg.env.action_dim, generator=gen) * 2 - 1).to(trainer.device),
        torch.randn(1, n, generator=gen).to(trainer.device),
        torch.ones(1, n, device=trainer.device))
    return trainer, ring


def run_ac_step(cfg, card: str) -> dict:
    """The actor-critic path: Trainer.ac_step at the flagship widths.  Returns
    the kernels' launches over its AC_STEPS timed steps."""
    import torch

    from dreamer_tpu_torch.ops.conv_cuda import encoder_forward
    from dreamer_tpu_torch.ops.gru_cuda import gru_cell
    from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
    from dreamer_tpu_torch.ops.imagine_cuda import hold_rollout, imagine_rollout

    trainer, ring = flagship_trainer(cfg)
    state = trainer.init_state()
    ac = state.ac
    draw_zero_params([ac.actor], torch.Generator().manual_seed(6))
    gen = torch.Generator(device="cuda").manual_seed(7)
    Tw = cfg.train.sequence_length // 2
    E = cfg.train.ac_epochs
    want = {"imagine_rollout": E, "encoder": E, "gru_cell": E * (Tw - 1), "gru_scan": 0}
    kernels = {"imagine_rollout": imagine_rollout, "encoder": encoder_forward,
               "gru_cell": gru_cell, "gru_scan": gru_scan}
    actor0 = [p.detach().clone() for p in ac.actor.parameters()]
    critic0 = [p.detach().clone() for p in ac.critic.parameters()]
    state, _ = trainer.ac_step(state, ring, gen)  # warm-up
    torch.cuda.synchronize()
    for k in kernels.values():
        k.launches = 0
    times = []
    for step in range(AC_STEPS):
        before = {n: k.launches for n, k in kernels.items()}
        start = time.perf_counter()
        state, metrics = trainer.ac_step(state, ring, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
        got = {n: k.launches - before[n] for n, k in kernels.items()}
        if got != want:
            fail(f"ac_step {step}: launches {got}, expected {want}")
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v))]
        if bad or float(metrics["ac/update_skipped"]) != 0.0:
            fail(f"ac_step {step}: non-finite {bad} or a skipped update")
    launches = {n: k.launches for n, k in kernels.items()}
    for name, before in (("actor", actor0), ("critic", critic0)):
        now = getattr(ac, name).parameters()
        if all(torch.equal(a, b) for a, b in zip(before, now)):
            fail(f"ac_step: the {name}'s parameters did not change")
    print(f"ac_step: {AC_STEPS} steps after 1 warm-up: "
          + " ".join(f"{1e3 * t:.1f}" for t in times)
          + f" ms; mean {1e3 * sum(times) / len(times):.2f} ms/ac_step "
          f"({E} updates each); launches per step imagine {want['imagine_rollout']}, "
          f"encoder {want['encoder']}, gru_cell {want['gru_cell']} (held); last metrics "
          + ", ".join(f"{k.split('/')[-1]}={float(v):.4g}" for k, v in metrics.items())
          + f" on {card}", flush=True)

    # One update by hand: the target critic moves by tau toward the new
    # critic; then a dream from the update's own warm start.
    batch = trainer.buffer.sample(ring, cfg.train.batch_size, gen, t_out=Tw,
                                  with_scalars=False)
    noise = trainer.sample_ac_noise(cfg.train.batch_size, gen)
    target0 = [p.detach().clone() for p in ac.target_critic.parameters()]
    ac, _ = trainer.agent.ac_update(ac, trainer.rssm, batch, noise)
    tau = cfg.agent.target_tau
    for t0, c1, t1 in zip(target0, ac.critic.parameters(), ac.target_critic.parameters()):
        want_t = (1.0 - tau) * t0 + tau * c1.detach()
        if (t1 - want_t).abs().max() > 1e-6 * (1 + want_t.abs().max()):
            fail("ac_step: the target critic did not move by tau toward the critic")
    with torch.no_grad():
        z0, h0 = trainer.rssm.warm_start(batch[0], batch[1], noise.warm)
        traj = trainer.rssm.imagine(ac.actor, z0, h0, noise.eps, noise.gum, cfg.agent.min_std)
    if traj.action.abs().max() > 1.0 or not bool(torch.isfinite(traj.h).all()):
        fail("ac_step: dream actions outside [-1, 1] or non-finite states")
    one_hot_rows(traj.z.reshape(-1, cfg.wm.latent_dim), cfg.wm, "ac_step: dream z")
    one_hot_rows(z0, cfg.wm, "ac_step: warm-start z")
    # The kernel at the path's own operands (the trained actor, the warm
    # start's states), held step by step.
    weights = [*ac.actor.imagine_weights(), *trainer.rssm.nets.imagine_weights()]
    dream = [v.float().contiguous() for v in (h0, z0, noise.eps, noise.gum)]
    out = imagine_rollout(*dream, weights, cfg.wm.unimix, cfg.agent.min_std)
    report_hold(hold_rollout(out, *dream[2:], weights, cfg.wm.unimix, cfg.agent.min_std),
                "ac_step's dream: the updated actor from the warm start's states")
    print(f"ac_step: target critic moved by tau={tau} (held); dream actions in [-1, 1], "
          f"latents one-hot (held); dream action mean |a| "
          f"{float(traj.action.abs().mean()):.3f}", flush=True)
    profile_ac_step(trainer, state, ring, card)
    return launches


PHASES = ("ac_update/", "wm_update/")
PORT_KERNELS = ("encoder_conv_kernel", "gru_cell_kernel", "gru_scan_kernel", "imagine_kernel")


def profile_step(label: str, step, card: str, top: int = 8) -> None:
    """One call of ``step`` (a learner step) under torch.profiler: the
    device's busy share, the host's time in each phase range (train/agent.py,
    train/world_model.py) and the kernels that take the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - start) * 1e6
    # The phase ranges also appear as device-side annotations spanning their
    # kernels: those are not device work and are left out of the sums.
    per_kernel = [(e.self_device_time_total, e.count, e.key) for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                  and not e.key.startswith(PHASES)]
    busy = sum(d for d, _, _ in per_kernel)
    if busy == 0:
        print(f"profile: {label}: torch.profiler saw no device time: not measured", flush=True)
        return
    print(f"profile: {label}: device busy {busy / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms wall "
          f"({100 * busy / wall_us:.1f}% busy; the profiler slows the host), "
          f"{sum(c for _, c, _ in per_kernel)} device kernels, on {card}", flush=True)
    # The host's time inside each range, the losses being the rest.
    for e in sorted(prof.key_averages(), key=lambda e: e.key):
        if e.key.startswith(PHASES) and e.device_type == DeviceType.CPU:
            print(f"profile: {label}   phase {e.key}: x{e.count}, host "
                  f"{e.cpu_time_total / 1e3:.2f} ms of {wall_us / 1e3:.2f} ms", flush=True)
    for dev, cnt, key in sorted(per_kernel, reverse=True)[:top]:
        print(f"profile: {label}   {dev / 1e3:8.3f} ms  x{cnt}  {key[:90]}", flush=True)
    # The port's kernels, each summed over its instantiations.
    totals = {name: [0.0, 0] for name in PORT_KERNELS}
    for dev, cnt, key in per_kernel:
        for name in PORT_KERNELS:
            if name in key:
                totals[name][0] += dev
                totals[name][1] += cnt
    print(f"profile: {label}   port kernels: "
          + ", ".join(f"{n} {d / 1e3:.3f} ms x{c}" for n, (d, c) in totals.items()), flush=True)


def profile_ac_step(trainer, state, ring, card: str) -> None:
    import torch

    gen = torch.Generator(device="cuda").manual_seed(8)
    profile_step("ac_step", lambda: trainer.ac_step(state, ring, gen), card)


def run_train_iteration(cfg, card: str) -> dict:
    """The main path: Trainer.train_iteration at the flagship widths.  Returns
    the kernels' launches over its TRAIN_ITERATIONS timed iterations."""
    import torch

    from dreamer_tpu_torch.ops import imagine_scan
    from dreamer_tpu_torch.ops.conv_cuda import encoder_forward
    from dreamer_tpu_torch.ops.gru_cuda import gru_cell, gru_kernel_layout
    from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
    from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout
    from dreamer_tpu_torch.ops.observe_scan import hold_observe

    trainer, ring = flagship_trainer(cfg)
    state = trainer.init_state()
    nets = trainer.rssm.nets
    draw_zero_params([state.ac.actor], torch.Generator().manual_seed(12))
    gen = torch.Generator(device="cuda").manual_seed(13)
    t = cfg.train
    Tw = t.sequence_length // 2
    want = {"gru_scan": t.wm_epochs, "encoder": t.wm_epochs + t.ac_epochs,
            "imagine_rollout": t.ac_epochs,
            "gru_cell": t.wm_epochs * t.horizon + t.ac_epochs * (Tw - 1)}
    kernels = {"gru_scan": gru_scan, "encoder": encoder_forward,
               "imagine_rollout": imagine_rollout, "gru_cell": gru_cell}

    # Warm-up, recording the GRU layout each imagination launch reads: the
    # actor-critic half must read the world model as its update left it.
    read, real = [], imagine_scan.imagine_rollout
    layout0 = nets.gru.kernel_weights()[0].clone()

    def recorder(h0, z0, eps, gum, weights, unimix, min_std):
        read.append(weights[12])
        return real(h0, z0, eps, gum, weights, unimix, min_std)

    imagine_scan.imagine_rollout = recorder
    try:
        state, _ = trainer.train_iteration(state, ring, gen)
    finally:
        imagine_scan.imagine_rollout = real
    fresh = gru_kernel_layout(nets.gru.kernel_i, nets.gru.kernel_h, nets.gru.bias_i,
                              nets.gru.bias_h, torch.bfloat16)[0]
    if len(read) != t.ac_epochs or not all(torch.equal(w, fresh) for w in read) \
            or torch.equal(fresh, layout0):
        fail("train_iteration: the actor-critic half did not read the updated world model's "
             "kernel layouts")
    torch.cuda.synchronize()

    wm_times = []
    wm_step = trainer.wm_step

    def timed_wm_step(*args):
        torch.cuda.synchronize()
        start = time.perf_counter()
        out = wm_step(*args)
        torch.cuda.synchronize()
        wm_times.append(time.perf_counter() - start)
        return out

    trainer.wm_step = timed_wm_step
    wm0 = [p.detach().clone() for p in nets.parameters()]
    for k in kernels.values():
        k.launches = 0
    times = []
    for it in range(TRAIN_ITERATIONS):
        before = {n: k.launches for n, k in kernels.items()}
        start = time.perf_counter()
        state, metrics = trainer.train_iteration(state, ring, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - start)
        got = {n: k.launches - before[n] for n, k in kernels.items()}
        if got != want:
            fail(f"train_iteration {it}: launches {got}, expected {want}")
        bad = [k for k, v in metrics.items() if not bool(torch.isfinite(v).all())]
        if bad or float(metrics["wm/update_skipped"]) or float(metrics["ac/update_skipped"]):
            fail(f"train_iteration {it}: non-finite {bad} or a skipped update")
    launches = {n: k.launches for n, k in kernels.items()}
    del trainer.wm_step
    still = sum(torch.equal(a, b) for a, b in zip(wm0, nets.parameters()))
    if still:
        fail(f"train_iteration: {still} of {len(wm0)} world-model parameters did not move")
    if int(state.step) != 1 + TRAIN_ITERATIONS:
        fail(f"train_iteration: step is {int(state.step)}")
    print(f"train_iteration: {TRAIN_ITERATIONS} iterations after 1 warm-up: "
          + " ".join(f"{1e3 * x:.1f}" for x in times)
          + f" ms; median {1e3 * statistics.median(times):.2f}, mean "
          f"{1e3 * sum(times) / len(times):.2f} ms/train_iteration; wm_step "
          + " ".join(f"{1e3 * x:.1f}" for x in wm_times)
          + f" ms, median {1e3 * statistics.median(wm_times):.2f}, mean "
          f"{1e3 * sum(wm_times) / len(wm_times):.2f} ms/wm_step "
          f"({t.wm_epochs} WM + {t.ac_epochs} AC updates each); launches per iteration "
          + ", ".join(f"{n} {v}" for n, v in want.items())
          + f" (held); all {len(wm0)} world-model parameters moved; the AC half read the "
          f"updated layouts (held); last metrics "
          + ", ".join(f"{k.split('/')[-1]}={float(v.float().mean()):.4g}"
                      for k, v in metrics.items() if k.startswith("wm/"))
          + f" on {card}", flush=True)

    # The posterior scan's kernels at an update's own operands.
    H = t.horizon
    obs, actions = trainer.buffer.sample(ring, t.batch_size, gen, t_out=H, with_scalars=False)
    gum = trainer.sample_wm_noise(t.batch_size, gen)
    with torch.no_grad():
        seq = trainer.rssm.observe_sequence(obs, actions, gum)
        feats = nets.encode_obs(obs, train=True).transpose(0, 1)
    a_in = torch.cat([torch.zeros_like(actions[:, :1]), actions[:, :-1]], 1).transpose(0, 1)
    stats = hold_observe(nets, feats, a_in, gum, seq.h.transpose(0, 1), seq.z.transpose(0, 1))
    print(f"train_iteration: the posterior scan's kernels at the update's own {stats['rows']} "
          f"pre-step states: GRU cell relaunched, differing from the forward bit for bit in "
          f"{int(stats['carry_mismatches'])} (step, row) pairs; max |cell - plain| "
          f"{stats['max_abs_err_cell']:.3e} (tol 2e-2 abs + rel); near ties "
          f"{int(stats['near_ties'])} of {int(stats['latent_rows'])} latent rows, flipped "
          f"there {int(stats['flips'])}, elsewhere {int(stats['flips_not_near_tie'])}; "
          f"whole-scan GRU at T 1 x {stats['rows']}: max |kernel - plain| "
          + " ".join(f"{n} {stats[f'scan_max_abs_err_{n}']:.3e}"
                     for n in ("h_seq", "r", "z", "n", "hn"))
          + f" (tol 1e-3 abs + rel); its h' in bf16 differing from the forward's in "
          f"{int(stats['scan_vs_forward_mismatches'])} (step, row) pairs (gated: 0)", flush=True)
    if stats["failures"]:
        fail(f"train_iteration: posterior scan kernels: {stats['failures']}")
    # The backward takes its GRU residuals from the scan kernel at the
    # forward's own states: one K schedule makes them the cell's, bit for bit.
    if stats["scan_vs_forward_mismatches"]:
        fail(f"train_iteration: the whole-scan GRU at T = 1 differs from the forward's GRU "
             f"cell in {int(stats['scan_vs_forward_mismatches'])} (step, row) pairs")
    one_hot_rows(seq.z.reshape(-1, cfg.wm.latent_dim), cfg.wm, "train_iteration: posterior z")

    gen_p = torch.Generator(device="cuda").manual_seed(14)
    profile_step("train_iteration", lambda: trainer.train_iteration(state, ring, gen_p), card,
                 top=10)
    return launches


def check_wm_update_vs_cpu(cfg, card: str) -> None:
    """One wm_update on the card and on the CPU (plain versions), from the
    same seeded weights (the parameters the init leaves zero drawn), batch and
    gumbels, in bf16 on both, held to WM_CARD_VS_CPU_RTOL: a sanity check of
    the update on the card, guarding no kernel."""
    import torch

    from dreamer_tpu_torch.core.dists import sample_gumbel
    from dreamer_tpu_torch.train import wm_update

    c, t = cfg.wm, cfg.train
    B, H = t.batch_size, t.horizon
    gum = sample_gumbel((H, B, c.latent_rows, c.latent_classes),
                        torch.Generator().manual_seed(15), "cpu")

    def update(device):
        trainer, ring = flagship_trainer(cfg, device)
        state = trainer.init_state()
        draw_zero_params([trainer.rssm.nets], torch.Generator().manual_seed(16))
        draws = torch.Generator().manual_seed(17)
        hi = trainer.buffer.valid_starts(ring)
        env_idx, starts = trainer.buffer.pick_indices(ring, *(
            torch.randint(0, n, (B,), generator=draws).to(device)
            for n in (trainer.buffer.num_envs, hi, hi)))
        batch = trainer.buffer.gather(ring, env_idx, starts, H)
        start = time.perf_counter()
        _, metrics = wm_update(trainer.rssm, trainer.wm_opt, state.wm, batch, gum.to(device),
                               cfg)
        metrics = {k: float(v) for k, v in metrics.items()}
        print(f"wm_update: one update on {device} in {time.perf_counter() - start:.2f} s",
              flush=True)
        return metrics

    ref, got = update("cpu"), update("cuda")
    gated = ("wm/loss", "wm/loss_pred", "wm/kl_dyn", "wm/kl_rep", "wm/grad_norm")
    worst = 0.0
    for k in ref:
        rel = abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6)
        if k in gated:
            worst = max(worst, rel)
        print(f"wm_update: card vs cpu {k}: card {got[k]:.6g} cpu {ref[k]:.6g} rel {rel:.3e}"
              f"{' (gated)' if k in gated else ''}", flush=True)
    print(f"wm_update: card vs cpu, worst relative difference of the losses and gradient norm "
          f"{worst:.3e} (tolerance {WM_CARD_VS_CPU_RTOL}, a sanity check) on {card}", flush=True)
    if worst > WM_CARD_VS_CPU_RTOL or got["wm/update_skipped"] or ref["wm/update_skipped"]:
        fail(f"wm_update: card vs cpu differ by {worst:.3e} rel (tolerance "
             f"{WM_CARD_VS_CPU_RTOL}) or an update was skipped")


def run_lifecycle(cfg, card: str) -> dict:
    """The training lifecycle through its entry point: ``cli.train.main`` on
    configs/car_racer.yaml with ``LIFECYCLE``, then again with ``--resume``
    and a longer schedule, its eval episodes of ``LIFECYCLE_EVAL_STEPS``.
    Gates the resume (iteration and ring restored, the rest of the schedule
    run), the metrics of every iteration, the best export, the kernels'
    launches in rollout and eval, eval's compaction from 2 rows to 1, and
    holds the GRU cell and the encoder to their plain versions at the
    serving rows the lifecycle launches them at.  Returns each kernel's
    launches over both runs."""
    import csv
    import functools
    import tempfile

    import torch

    from dreamer_tpu_torch.cli import train as cli
    from dreamer_tpu_torch.envs import EnvFarm, FakeEnv
    from dreamer_tpu_torch.nets import gru, wm_nets
    from dreamer_tpu_torch.ops import conv_cuda, gru_cuda
    from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
    from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout
    from dreamer_tpu_torch.orchestrator import dreamer as orch
    from dreamer_tpu_torch.train.step import Policy
    from dreamer_tpu_torch.utils.checkpoint import load

    kernels = {"gru_cell": gru_cuda.gru_cell, "gru_scan": gru_scan,
               "encoder": conv_cuda.encoder_forward, "imagine_rollout": imagine_rollout}
    by_phase = {phase: dict.fromkeys(kernels, 0) for phase in ("rollout", "eval")}
    serving_rows = max(cfg.env.num_envs, 2)
    held = {"gru_cell": set(), "encoder": set()}
    restored = {}
    eval_rows = set()
    real = {"collect": orch.Dreamer._collect_chunk, "eval": orch.Dreamer._evaluate_batched,
            "restore": orch.Dreamer.restore_latest, "cell": gru.gru_cell,
            "encode": wm_nets.encode, "observe": Policy.policy_observe}

    def counted(phase, fn):
        def run(self, *args):
            before = {n: k.launches for n, k in kernels.items()}
            out = fn(self, *args)
            for n, k in kernels.items():
                by_phase[phase][n] += k.launches - before[n]
            return out
        return run

    def evaluate(self, episodes, max_steps):
        if self._eval_farm is None:
            self._eval_farm = EnvFarm(
                [functools.partial(FakeEnv, obs_size=tuple(self.cfg.wm.obs_size), episode_len=n)
                 for n in LIFECYCLE_EVAL_STEPS], seed=self._eval_seed)
        return real["eval"](self, episodes, max_steps)

    # Only eval (and the unused run) observes through policy_observe.
    def observe(self, z, h, *args):
        eval_rows.add(h.shape[0])
        return real["observe"](self, z, h, *args)

    def restore(self):
        found = real["restore"](self)
        restored.update(found=found, iteration=self.iteration, size=self.buf.size)
        return found

    def cell(x, h, *w):
        out = real["cell"](x, h, *w)
        if x.shape[0] <= serving_rows and x.shape[0] not in held["gru_cell"]:
            held["gru_cell"].add(x.shape[0])
            max_err(out, gru_cuda.gru_cell_plain(x, h, *w), gru_cuda.tolerance,
                    f"lifecycle: GRU cell at the path's {x.shape[0]} rows")
        return out

    # The path's own calls are wrapped where it calls them (the wrappers'
    # launch counters stay theirs).
    def encode(obs, table, operands, params):
        out = real["encode"](obs, table, operands, params)
        if obs.shape[0] <= serving_rows and obs.shape[0] not in held["encoder"]:
            held["encoder"].add(obs.shape[0])
            max_err(out, conv_cuda.encoder_forward_plain(obs, *operands, table),
                    conv_cuda.tolerance, f"lifecycle: encoder at the path's {obs.shape[0]} "
                    "frames")
        return out

    first, total = LIFECYCLE_ITERATIONS
    times, rewards = [], []
    with tempfile.TemporaryDirectory() as tmp:
        models, logs = Path(tmp) / "models", Path(tmp) / "logs"
        argv = ["--config", str(CONFIG), "--overrides", *LIFECYCLE,
                f"runtime.checkpoint_dir={models}", f"runtime.log_dir={logs}"]
        orch.Dreamer._collect_chunk = counted("rollout", real["collect"])
        orch.Dreamer._evaluate_batched = counted("eval", evaluate)
        orch.Dreamer.restore_latest = restore
        Policy.policy_observe = observe
        gru.gru_cell, wm_nets.encode = cell, encode
        for k in kernels.values():
            k.launches = 0
        try:
            start = time.perf_counter()
            rewards.append(cli.main(argv + [f"train.training_iterations={first}"]))
            times.append(time.perf_counter() - start)
            saved = load(str(models / f"ckpt_{first}"))["buffer"]["size"]
            start = time.perf_counter()
            rewards.append(cli.main(["--resume"] + argv
                                    + [f"train.training_iterations={total}"]))
            times.append(time.perf_counter() - start)
        finally:
            orch.Dreamer._collect_chunk, orch.Dreamer._evaluate_batched = (real["collect"],
                                                                          real["eval"])
            orch.Dreamer.restore_latest = real["restore"]
            Policy.policy_observe = real["observe"]
            gru.gru_cell, wm_nets.encode = real["cell"], real["encode"]
        launches = {n: k.launches for n, k in kernels.items()}
        rows = []
        for name in ("metrics.leg1.csv", "metrics.csv"):
            with open(logs / name) as f:
                rows += list(csv.DictReader(f))
        best = [(models / n).exists() for n in ("best.json", "agent_best")]

    if restored != {"found": True, "iteration": first, "size": saved}:
        fail(f"lifecycle: the resumed run restored {restored}, expected iteration {first} "
             f"and a ring of {saved}")
    steps = [r for r in rows if r.get("wm/loss")]
    if [int(r["iteration"]) for r in steps] != list(range(1, total + 1)):
        fail(f"lifecycle: metrics rows for iterations {[r['iteration'] for r in steps]}")
    for r in steps:
        for key in ("wm/loss", "ac/loss_actor", "ac/loss_critic"):
            if not math.isfinite(float(r[key])):
                fail(f"lifecycle: iteration {r['iteration']} {key} = {r[key]}")
    if not all(best):
        fail("lifecycle: best.json or agent_best was not written")
    for phase, counts in by_phase.items():
        if not (counts["gru_cell"] and counts["encoder"]):
            fail(f"lifecycle: {phase} launched {counts}")
    if eval_rows != {1, 2}:
        fail(f"lifecycle: eval observed at rows {sorted(eval_rows)}, expected 2 compacted to 1")
    if held != {"gru_cell": {1, 2}, "encoder": {1, 2}}:
        fail(f"lifecycle: the serving rows checked were {held}, expected 1 (rollout and "
             "compacted eval) and 2 (eval)")
    evals = [f"{float(r['eval/mean_reward']):.2f} (iter {r['iteration']})" for r in rows
             if r.get("eval/mean_reward")]
    print(f"lifecycle: cli.train at {CONFIG.name}'s widths with {' '.join(LIFECYCLE)} (the "
          f"ring cut to 2,000 of 200,000 steps: capacity is not a width); run 1 "
          f"{first} iterations in {times[0]:.2f} s, run 2 resumed at iteration "
          f"{restored['iteration']} with a ring of {restored['size']} steps, to {total}, in "
          f"{times[1]:.2f} s on {card}", flush=True)
    print(f"lifecycle: median perf/env_steps_per_s "
          f"{statistics.median(float(r['perf/env_steps_per_s']) for r in steps):.2f}, "
          f"perf/learner_s {statistics.median(float(r['perf/learner_s']) for r in steps):.4f}"
          f", perf/rollout_s {statistics.median(float(r['perf/rollout_s']) for r in steps):.4f}"
          f"; wm/loss " + " ".join(f"{float(r['wm/loss']):.1f}" for r in steps)
          + f"; eval rewards {', '.join(evals)}; final {rewards[0]:.2f}, {rewards[1]:.2f}",
          flush=True)
    print(f"lifecycle: launches over both runs {launches}; in rollout {by_phase['rollout']}, "
          f"in eval {by_phase['eval']} (episodes of {LIFECYCLE_EVAL_STEPS} steps, rows "
          f"compacted 2 -> 1); best.json and agent_best written", flush=True)
    medians = {k: statistics.median(float(r[k]) for r in steps)
               for k in ("perf/rollout_s", "perf/env_steps_per_s")}
    return launches, medians


def lunar_lander_stand_in(env_id: str, render_mode=None, max_episode_steps=None, **kwargs):
    """The async leg's base-env maker, with ``gymnasium.make``'s signature: the
    fake env at LunarLander's 400 x 600 render size with the config's
    ``action_dim``.  It takes only what ``make_env`` passes for a
    pixel-from-render id, so that the leg holds those keywords too."""
    from dreamer_tpu_torch.config import DreamerConfig
    from dreamer_tpu_torch.envs import FakeEnv

    if not env_id.startswith("LunarLander") or render_mode != "rgb_array" \
            or kwargs != {"continuous": True}:
        raise ValueError(f"stand-in for LunarLander asked for {env_id!r}, "
                         f"render_mode={render_mode!r}, {kwargs}")
    return FakeEnv(obs_size=STAND_IN_FRAME,
                   action_dim=DreamerConfig.from_yaml(str(CONFIG)).env.action_dim,
                   episode_len=max_episode_steps or 100)


def run_async_lifecycle(cfg, card: str, one_env: dict) -> dict:
    """The lifecycle through ``cli.train.main`` with ``ASYNC_LEG``: the
    rollout in ``AsyncEnvFarm``'s spawned workers over a real env's wrapper
    stack, eval in process, then ``--resume``.  ``one_env`` holds the
    one-env leg's medians, printed beside this leg's.  Returns each kernel's
    launches over both runs."""
    import csv
    import os
    import tempfile

    import numpy as np

    from dreamer_tpu_torch.cli import train as cli
    from dreamer_tpu_torch.envs import make_env, vector
    from dreamer_tpu_torch.nets import gru, wm_nets
    from dreamer_tpu_torch.ops import conv_cuda, gru_cuda
    from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
    from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout
    from dreamer_tpu_torch.orchestrator import dreamer as orch
    from dreamer_tpu_torch.utils.checkpoint import load

    kernels = {"gru_cell": gru_cuda.gru_cell, "gru_scan": gru_scan,
               "encoder": conv_cuda.encoder_forward, "imagine_rollout": imagine_rollout}
    rollout = dict.fromkeys(kernels, 0)
    n_envs = ASYNC_ENVS
    held = {"gru_cell": set(), "encoder": set()}
    rounds, farms, evals, restored = [], [], [], {}
    steps, step_s = [0], []
    real = {"collect": orch.Dreamer._collect_chunk, "eval": orch.Dreamer._evaluate_batched,
            "restore": orch.Dreamer.restore_latest, "step": vector.AsyncEnvFarm.step,
            "cell": gru.gru_cell, "encode": wm_nets.encode}

    def collect(self, *args):
        before = {n: k.launches for n, k in kernels.items()}
        steps[0] = 0
        out = real["collect"](self, *args)
        rounds.append(steps[0])
        for n, k in kernels.items():
            rollout[n] += k.launches - before[n]
        f = self.farm
        farms.append((type(f).__name__, tuple(p.pid for p in f.workers),
                      {type(p).__name__ for p in f.workers},
                      all(p.is_alive() for p in f.workers)))
        return out

    def step(self, actions):
        steps[0] += len(actions)
        start = time.perf_counter()
        out = real["step"](self, actions)
        step_s.append(time.perf_counter() - start)
        return out

    def evaluate(self, episodes, max_steps):
        out = real["eval"](self, episodes, max_steps)
        evals.append(type(self._eval_farm).__name__)
        return out

    def restore(self):
        found = real["restore"](self)
        restored.update(found=found, iteration=self.iteration, size=self.buf.size,
                        farm_seed=self.farm.seed)
        return found

    def cell(x, h, *w):
        out = real["cell"](x, h, *w)
        if x.shape[0] == n_envs and n_envs not in held["gru_cell"]:
            held["gru_cell"].add(n_envs)
            max_err(out, gru_cuda.gru_cell_plain(x, h, *w), gru_cuda.tolerance,
                    f"async lifecycle: GRU cell at the rollout's {n_envs} rows")
        return out

    def encode(obs, table, operands, params):
        out = real["encode"](obs, table, operands, params)
        if obs.shape[0] == n_envs and n_envs not in held["encoder"]:
            held["encoder"].add(n_envs)
            max_err(out, conv_cuda.encoder_forward_plain(obs, *operands, table),
                    conv_cuda.tolerance, f"async lifecycle: encoder at the rollout's {n_envs} "
                    "frames")
        return out

    first, total = ASYNC_ITERATIONS
    times = []
    with tempfile.TemporaryDirectory() as tmp:
        models, logs = Path(tmp) / "models", Path(tmp) / "logs"
        argv = ["--config", str(CONFIG), "--env-maker", ASYNC_MAKER, "--overrides", *ASYNC_LEG,
                f"runtime.checkpoint_dir={models}", f"runtime.log_dir={logs}"]
        orch.Dreamer._collect_chunk, orch.Dreamer._evaluate_batched = collect, evaluate
        orch.Dreamer.restore_latest, vector.AsyncEnvFarm.step = restore, step
        gru.gru_cell, wm_nets.encode = cell, encode
        for k in kernels.values():
            k.launches = 0
        try:
            start = time.perf_counter()
            cli.main(argv + [f"train.training_iterations={first}"])
            times.append(time.perf_counter() - start)
            saved = load(str(models / f"ckpt_{first}"))
            start = time.perf_counter()
            cli.main(["--resume"] + argv + [f"train.training_iterations={total}"])
            times.append(time.perf_counter() - start)
        finally:
            orch.Dreamer._collect_chunk, orch.Dreamer._evaluate_batched = (real["collect"],
                                                                          real["eval"])
            orch.Dreamer.restore_latest, vector.AsyncEnvFarm.step = (real["restore"],
                                                                     real["step"])
            gru.gru_cell, wm_nets.encode = real["cell"], real["encode"]
        launches = {n: k.launches for n, k in kernels.items()}
        rows = []
        for name in ("metrics.leg1.csv", "metrics.csv"):
            with open(logs / name) as f:
                rows += [r for r in csv.DictReader(f) if r.get("wm/loss")]

    # Where a farm step goes: one env's step of the same stack in this process.
    env = make_env(ASYNC_ENV_ID, obs_size=tuple(cfg.wm.obs_size),
                   action_repeat=cfg.env.action_repeat, base_make=ASYNC_MAKER)
    env.reset(seed=0)
    one_step_s = []
    for _ in range(20):
        start = time.perf_counter()
        env.step(np.zeros(cfg.env.action_dim, np.float32))
        one_step_s.append(time.perf_counter() - start)
    env.close()

    want_steps = n_envs * cfg.train.sequence_length
    if not rounds or set(rounds) != {want_steps}:
        fail(f"async lifecycle: env steps per round {rounds}, expected {want_steps}")
    for name, pids, kinds, alive in farms:
        if name != "AsyncEnvFarm" or kinds != {"SpawnProcess"}:
            fail(f"async lifecycle: the rollout ran on {name}, its workers {kinds}")
        if len(set(pids)) != n_envs or os.getpid() in pids or not alive:
            fail(f"async lifecycle: workers {pids} (alive {alive}), this process {os.getpid()}")
    if len({f[1] for f in farms}) != 2:
        fail(f"async lifecycle: expected one farm a run, saw workers {[f[1] for f in farms]}")
    if not evals or set(evals) != {"EnvFarm"}:
        fail(f"async lifecycle: eval ran on {evals}, expected the in-process EnvFarm")
    expect = {"found": True, "iteration": first, "size": int(saved["buffer"]["size"]),
              "farm_seed": int(saved["env_seed"])}
    if restored != expect:
        fail(f"async lifecycle: the resumed run restored {restored}, expected {expect}")
    if [int(r["iteration"]) for r in rows] != list(range(1, total + 1)):
        fail(f"async lifecycle: metrics rows for iterations {[r['iteration'] for r in rows]}")
    for r in rows:
        for key in ("wm/loss", "ac/loss_actor", "ac/loss_critic"):
            if not math.isfinite(float(r[key])):
                fail(f"async lifecycle: iteration {r['iteration']} {key} = {r[key]}")
    if not (rollout["gru_cell"] and rollout["encoder"]):
        fail(f"async lifecycle: rollout launched {rollout}")
    if held != {"gru_cell": {n_envs}, "encoder": {n_envs}}:
        fail(f"async lifecycle: the rollout rows checked were {held}, expected {n_envs}")
    medians = {k: statistics.median(float(r[k]) for r in rows)
               for k in ("perf/rollout_s", "perf/env_steps_per_s", "perf/learner_s")}
    print(f"async lifecycle: cli.train at {CONFIG.name}'s widths with {' '.join(ASYNC_LEG)} "
          f"--env-maker {ASYNC_MAKER} ({STAND_IN_FRAME[0]} x {STAND_IN_FRAME[1]} frames); "
          f"{n_envs} spawned workers a run (pids {sorted({f[1] for f in farms})}, "
          f"this process {os.getpid()}); {len(rounds)} rounds of {want_steps} env steps; "
          f"eval on {evals[0]}; run 1 {first} iterations in {times[0]:.2f} s, run 2 resumed at "
          f"iteration {restored['iteration']} (ring {restored['size']}, farm seed "
          f"{restored['farm_seed']}) to {total} in {times[1]:.2f} s on {card}", flush=True)
    print(f"async lifecycle: median perf/rollout_s {medians['perf/rollout_s']:.4f} and "
          f"perf/env_steps_per_s {medians['perf/env_steps_per_s']:.2f} ({n_envs} envs in "
          f"spawned workers) beside the one-env leg's {one_env['perf/rollout_s']:.4f} and "
          f"{one_env['perf/env_steps_per_s']:.2f}; perf/learner_s {medians['perf/learner_s']:.4f}; "
          f"launches over both runs {launches}, in "
          f"rollout {rollout}; GRU cell and encoder held at {n_envs} rows", flush=True)
    print(f"async lifecycle: median AsyncEnvFarm.step {statistics.median(step_s) * 1e3:.2f} ms "
          f"({n_envs} envs, {len(step_s)} steps) beside one env's step of the same stack in "
          f"this process {statistics.median(one_step_s) * 1e3:.2f} ms on {card}", flush=True)
    return launches


def hold_at_path(captured: dict, card: str, label: str = "lifecycle_64env") -> dict:
    """Each kernel held against its plain version at the operands the
    64-env learner gave it (``captured``: kernel -> {shape: operands}),
    with its time, its plain version's, one library call's and its bound.
    Returns, by kernel, the numbers for the ``kernels`` line."""
    import torch
    import torch.nn.functional as F

    from dreamer_tpu_torch.ops import conv_cuda, gru_cuda
    from dreamer_tpu_torch.ops import gru_scan_cuda as gs
    from dreamer_tpu_torch.ops import imagine_cuda as ic

    out = {}

    def record(name, key, err, t, extra=""):
        line = out.setdefault(name, {"max_abs_err": 0.0})
        line["max_abs_err"] = max(line["max_abs_err"], err)
        line[key] = t
        print(f"{label}: {name} at the path's {key}: kernel_ms={t['ms']:.4f} "
              f"plain_ms={t['plain_ms']:.4f} library_ms={fmt_ms(t['library_ms'])} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}){extra} on {card}", flush=True)

    # The encoder: four bf16 convs + SiLU over the update's and the warm
    # start's frames, cuDNN in the faster of NCHW and channels_last beside it.
    for n, (obs, table, ws, bs) in sorted(captured["encoder"].items()):
        got = conv_cuda.encoder_forward(obs, ws, bs, table)
        err = max_err(got, conv_cuda.encoder_forward_plain(obs, ws, bs, table),
                      conv_cuda.tolerance, f"{label}: encoder at the path's {n} frames")
        oihw = [w.permute(3, 2, 0, 1).contiguous() for w in ws]
        b16 = [b.to(torch.bfloat16) for b in bs]

        def library(fmt, obs=obs, table=table, oihw=oihw, b16=b16, n=n):
            wf = [w.contiguous(memory_format=fmt) for w in oihw]

            def run():
                x = table[obs.long()].permute(0, 3, 1, 2).contiguous(memory_format=fmt)
                for w, b in zip(wf, b16):
                    x = F.silu(F.conv2d(x, w, b, stride=2, padding=1))
                return x.permute(0, 2, 3, 1).reshape(n, -1)
            return run

        t = {"ms": cuda_ms(lambda: conv_cuda.encoder_forward(obs, ws, bs, table), 20),
             "plain_ms": cuda_ms(lambda: conv_cuda.encoder_forward_plain(obs, ws, bs, table),
                                 10),
             "library_ms": min(cuda_ms(library(fmt), 20)
                               for fmt in (torch.contiguous_format, torch.channels_last))}
        flops, cin, hw = 0, 3, obs.shape[1] * obs.shape[2]
        for w in ws:
            hw //= 4
            flops += 2 * n * hw * w.shape[3] * 16 * cin
            cin = w.shape[3]
        nbytes = obs.numel() + 2 * (sum(w.numel() for w in ws) + got.numel() + 256) \
            + 4 * sum(b.numel() for b in bs)
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
        record("encoder", f"{n} frames", err, t,
               f" ({flops / 1e9:.2f} GFLOP, channels {[w.shape[3] for w in ws]})")

    # The GRU cell at the posterior's and the warm start's rows.
    for n, (x, h, w) in sorted(captured["gru_cell"].items()):
        err = max_err(gru_cuda.gru_cell(x, h, *w), gru_cuda.gru_cell_plain(x, h, *w),
                      gru_cuda.tolerance, f"{label}: GRU cell at the path's {n} rows")
        I, H = x.shape[1], h.shape[1]
        lib = [w[0][:, :I].contiguous(), w[1][:, :H].contiguous(), w[2].to(torch.bfloat16),
               w[3].to(torch.bfloat16)]
        t = {"ms": cuda_ms(lambda: gru_cuda.gru_cell(x, h, *w), 200),
             "plain_ms": cuda_ms(lambda: gru_cuda.gru_cell_plain(x, h, *w), 200),
             "library_ms": cuda_ms(lambda: torch.gru_cell(x, h, *lib), 200)}
        nbytes = 2 * (n * I + n * H + 3 * H * (I + H) + n * H) + 2 * 6 * H
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, 2 * n * 3 * H * (I + H))
        record("gru_cell", f"{n} rows", err, t)

    # The whole-scan GRU at T 1 over the update's rows (the posterior scan's
    # backward), cuDNN's GRU (h_seq only) beside it.
    for (T, B), (xs, h0, ops) in sorted(captured["gru_scan"].items()):
        got = gs.gru_scan(xs, h0, *ops)
        stats = gs.compare(got, gs.gru_scan_plain(xs, h0, *ops))
        if stats["failures"]:
            fail(f"{label}: gru_scan at T {T} x B {B}: {stats['failures']}")
        err = max(stats[f"max_abs_err_{k}"] for k in gs.NAMES)
        print(f"{label}: gru_scan at the path's T " + f"{T} x B {B}: max |kernel - "
              "plain| " + " ".join(f"{k} {stats[f'max_abs_err_{k}']:.3e}" for k in gs.NAMES)
              + f" (tol {gs.TOL} abs + rel)", flush=True)
        I, H = xs.shape[2], h0.shape[1]
        lib_gru = torch.nn.GRU(I, H).to("cuda", torch.bfloat16)
        with torch.no_grad():
            lib_gru.weight_ih_l0.copy_(ops[0][:, :I])
            lib_gru.weight_hh_l0.copy_(ops[1][:, :H])
            lib_gru.bias_ih_l0.copy_(ops[2])
            lib_gru.bias_hh_l0.copy_(ops[3])
        lib_gru.flatten_parameters()
        h16 = h0.to(torch.bfloat16)[None]
        with torch.no_grad():
            t = {"ms": cuda_ms(lambda: gs.gru_scan(xs, h0, *ops), 20),
                 "plain_ms": cuda_ms(lambda: gs.gru_scan_plain(xs, h0, *ops), 20),
                 "library_ms": cuda_ms(lambda: lib_gru(xs, h16), 20)}
        t["bound_ms"], t["bound_by"] = bound_ms(*gs.bound_numbers(T, B, I, H))
        record("gru_scan", f"T {T} x B {B}", err, t)

    # The imagination at the AC update's B x T, the path's own weights and
    # start states, held step by step (hold_rollout).
    for (T, B), (h0, z0, eps, gum, weights, unimix, min_std) in sorted(
            captured["imagine_rollout"].items()):
        got = ic.imagine_rollout(h0, z0, eps, gum, weights, unimix, min_std)
        stats = report_hold(ic.hold_rollout(got, eps, gum, weights, unimix, min_std),
                            f"{label}: the path's B={B} T={T} rollout")
        err = max(stats[f"max_abs_err_{k}"] for k in ("h_next", "mu", "sigma", "action"))
        t = {"ms": cuda_ms(lambda: ic.imagine_rollout(h0, z0, eps, gum, weights, unimix,
                                                      min_std), 20),
             "plain_ms": cuda_ms(lambda: ic.imagine_rollout_plain(h0, z0, eps, gum, weights,
                                                                  unimix, min_std), 3, 1),
             "library_ms": None}
        nbytes, flops = ic.bound_numbers(B, T, weights, ic.dims_of(weights, h0, z0, eps))
        t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
        record("imagine_rollout", f"B {B} x T {T}", err, t)
    return out


def run_actor_learner_lifecycle(card: str) -> dict:
    """configs/car_racer_64env.yaml through ``cli.train.main``, as published
    but for ``LEG_64ENV``'s cuts: 64 envs in AsyncEnvFarm's workers, the
    host-local float32 actor on the CPU fed by a bfloat16 weight broadcast,
    asynchronous checkpoints; then ``--resume``; then two shorter variants,
    the overlapped rollout and the card's actor at 64 rows.  Gates the
    broadcast (exact, one before a round and none inside one), no kernel in
    the host actor's rollout and eval while the learner launches all four,
    the resume (iteration, ring, both generators), the asynchronous save
    (returns before its file lands, ``LATEST``, the restored step and
    weights), the overlap's staleness (each overlapped round acts with the
    weights of before its iteration's update) and the metrics rows; then
    holds each kernel against its plain version at the operands this
    learner gave it.  Returns the main run's launches and the kernels'
    numbers at this leg's shapes."""
    import csv
    import functools
    import tempfile
    import threading
    import types

    import torch

    from dreamer_tpu_torch.cli import train as cli
    from dreamer_tpu_torch.config import DreamerConfig
    from dreamer_tpu_torch.envs import EnvFarm, FakeEnv, vector
    from dreamer_tpu_torch.nets import gru, wm_nets
    from dreamer_tpu_torch.ops import (conv_cuda, gru_cuda, gru_scan_cuda, imagine_scan,
                                       observe_scan)
    from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
    from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout
    from dreamer_tpu_torch.orchestrator import broadcast
    from dreamer_tpu_torch.orchestrator import dreamer as orch
    from dreamer_tpu_torch.train import step as train_step
    from dreamer_tpu_torch.utils import checkpoint as ckpt_mod
    from dreamer_tpu_torch.utils.checkpoint import load

    cfg = DreamerConfig.from_yaml(str(CONFIG_64ENV), LEG_64ENV)
    r, t = cfg.runtime, cfg.train
    if (r.rollout_device, r.broadcast_dtype, r.async_checkpoint, cfg.env.num_envs,
            cfg.env.async_envs, t.batch_size) != ("cpu", "bfloat16", True, 64, True, 128):
        fail(f"lifecycle_64env: {CONFIG_64ENV.name} is not the published configuration")
    kernels = {"gru_cell": gru_cuda.gru_cell, "gru_scan": gru_scan,
               "encoder": conv_cuda.encoder_forward, "imagine_rollout": imagine_rollout}
    real = {"collect": orch.Dreamer._collect_chunk, "eval": orch.Dreamer._evaluate_batched,
            "restore": orch.Dreamer.restore_latest, "flatten": broadcast.flatten,
            "unflatten": broadcast.unflatten, "save": ckpt_mod.CheckpointManager.save,
            "iteration": train_step.Trainer.train_iteration, "cell": gru.gru_cell,
            "encode": wm_nets.encode, "imagine": imagine_scan.imagine_rollout,
            "farm_step": vector.AsyncEnvFarm.step}
    # What a run saw, made anew for each run.
    log = {}

    def fresh():
        log.clear()
        log.update(phase={p: dict.fromkeys(kernels, 0) for p in ("rollout", "eval")},
                   rounds=[], broadcasts=[], bcast_ms=[], bcast_mb=[], saves=[], restored={},
                   stale=[], thread_kernels=[], round_s=[], learner_s=[], farm_ms=[])

    # The kernels' operands at the 64-env learner's shapes, first call of each.
    captured = {name: {} for name in kernels}

    def keep(name, key, operands):
        if key not in captured[name]:
            captured[name][key] = tuple(o.clone() if isinstance(o, torch.Tensor) else
                                        [w.clone() for w in o] if isinstance(o, (list, tuple))
                                        else o for o in operands)

    def on_card(name, tensor):
        if tensor.is_cuda and threading.current_thread().name.startswith("rollout"):
            log["thread_kernels"].append(name)
        return tensor.is_cuda

    def cell(x, h, *w):
        if on_card("gru_cell", x) and x.shape[0] == t.batch_size:
            keep("gru_cell", x.shape[0], (x, h, list(w)))
        return real["cell"](x, h, *w)

    def encode(obs, table, operands, params):
        if on_card("encoder", obs) and obs.shape[0] >= t.batch_size:
            keep("encoder", obs.shape[0], (obs, table, *operands))
        return real["encode"](obs, table, operands, params)

    def scan(xs, h0, *ops):
        if on_card("gru_scan", xs):
            keep("gru_scan", tuple(xs.shape[:2]), (xs, h0, list(ops)))
        return gru_scan_cuda.gru_scan(xs, h0, *ops)

    # The posterior scan reaches the whole-scan GRU as gru_scan_cuda.gru_scan;
    # it sees this module instead (the wrapper's counter stays its own).
    scan_module = types.SimpleNamespace(**{**vars(gru_scan_cuda), "gru_scan": scan})

    def imagine(h0, z0, eps, gum, weights, unimix, min_std):
        if on_card("imagine_rollout", h0):
            keep("imagine_rollout", tuple(eps.shape[:2]),
                 (h0, z0, eps, gum, list(weights), unimix, min_std))
        return real["imagine"](h0, z0, eps, gum, weights, unimix, min_std)

    def stamp(d):
        return tuple((p.data_ptr(), p._version) for p in d._learner_weights())

    def probe(params):
        """Two tensors that tell weights apart: the first world-model and the
        first actor parameter."""
        return [params[0].detach().float().cpu().clone(),
                params[-1].detach().float().cpu().clone()]

    def collect(self, random_policy):
        overlapped = threading.current_thread().name.startswith("rollout")
        before = {n: k.launches for n, k in kernels.items()}
        n_bcast = len(log["broadcasts"])
        fresh_actor = overlapped or self._actor_stamp == stamp(self)
        actor = [*self.policy.rssm.nets.parameters(), *self.policy.actor.parameters()]
        start_w = probe(actor)
        start = time.perf_counter()
        out = real["collect"](self, random_policy)
        if not random_policy:
            log["round_s"].append(time.perf_counter() - start)
        log["rounds"].append({"broadcasts_before": n_bcast, "overlapped": overlapped,
                              "random": random_policy, "fresh": fresh_actor,
                              "mid_round_broadcasts": len(log["broadcasts"]) - n_bcast,
                              "weights": start_w, "unchanged": all(
                                  torch.equal(a, b) for a, b in zip(start_w, probe(actor))),
                              "device": self.policy.device.type})
        if not overlapped:
            for n, k in kernels.items():
                log["phase"]["rollout"][n] += k.launches - before[n]
        return out

    def evaluate(self, episodes, max_steps):
        if self._eval_farm is None:
            self._eval_farm = EnvFarm(
                [functools.partial(FakeEnv, obs_size=tuple(self.cfg.wm.obs_size), episode_len=n)
                 for n in EVAL_64ENV_STEPS], seed=self._eval_seed)
        before = {n: k.launches for n, k in kernels.items()}
        out = real["eval"](self, episodes, max_steps)
        for n, k in kernels.items():
            log["phase"]["eval"][n] += k.launches - before[n]
        return out

    def flatten(tensors, wire):
        torch.cuda.synchronize()
        start = time.perf_counter()
        flat = real["flatten"](tensors, wire)
        log["bcast_ms"].append((time.perf_counter() - start) * 1e3)
        log["bcast_mb"].append(flat.numel() * flat.element_size() / 1e6)
        log["broadcasts"].append(list(tensors))
        return flat

    def unflatten(flat, into):
        start = time.perf_counter()
        real["unflatten"](flat, into)
        log["bcast_ms"][-1] += (time.perf_counter() - start) * 1e3
        learner = log["broadcasts"][-1]
        bad = sum(not torch.equal(a, w.detach().to(torch.bfloat16).float().cpu())
                  for a, w in zip(into, learner))
        if bad or len(into) != len(learner):
            fail(f"lifecycle_64env: after a broadcast {bad} of {len(into)} actor tensors are "
                 "not the learner's rounded to bf16 and back")

    def save(self, step, tree):
        s = tree["state"]
        key = next(iter(s["wm"]))
        log["saves"].append({"step": step, "state_step": int(s["step"]),
                             "param": key, "sum": float(s["wm"][key].double().sum()),
                             "manager": self})
        return real["save"](self, step, tree)

    def restore(self):
        found = real["restore"](self)
        key = next(iter(self.state.wm.nets.state_dict()))
        log["restored"].update(
            found=found, iteration=self.iteration, size=self.buf.size,
            rng=self.rng.get_state(), rollout_rng=self.rollout_rng.get_state(),
            devices=(self.rng.device.type, self.rollout_rng.device.type),
            state_step=int(self.state.step),
            sum=float(self.state.wm.nets.state_dict()[key].double().sum()))
        return found

    def iteration(self, state, ring, generator, nu=None):
        log["stale"].append(probe([*state.wm.nets.parameters(),
                                   *state.ac.actor.parameters()]))
        start = time.perf_counter()
        out = real["iteration"](self, state, ring, generator, nu)
        torch.cuda.synchronize()
        log["learner_s"].append(time.perf_counter() - start)
        return out

    def farm_step(self, actions):
        start = time.perf_counter()
        out = real["farm_step"](self, actions)
        log["farm_ms"].append((time.perf_counter() - start) * 1e3)
        return out

    def rows_of(logs):
        rows = []
        for name in ("metrics.leg1.csv", "metrics.csv"):
            if (logs / name).exists():
                with open(logs / name) as f:
                    rows += [row for row in csv.DictReader(f) if row.get("wm/loss")]
        return rows

    first, total = ITERATIONS_64ENV
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        patches = ((orch.Dreamer, "_collect_chunk", collect),
                   (orch.Dreamer, "_evaluate_batched", evaluate),
                   (orch.Dreamer, "restore_latest", restore), (broadcast, "flatten", flatten),
                   (broadcast, "unflatten", unflatten),
                   (ckpt_mod.CheckpointManager, "save", save),
                   (train_step.Trainer, "train_iteration", iteration), (gru, "gru_cell", cell),
                   (wm_nets, "encode", encode), (observe_scan, "gru_scan_cuda", scan_module),
                   (imagine_scan, "imagine_rollout", imagine),
                   (vector.AsyncEnvFarm, "step", farm_step))
        originals = [(owner, attr, getattr(owner, attr)) for owner, attr, _ in patches]
        for owner, attr, fn in patches:
            setattr(owner, attr, fn)
        try:
            for variant, extra, iterations, resume in VARIANTS_64ENV:
                models, logs = Path(tmp) / variant / "models", Path(tmp) / variant / "logs"
                argv = ["--config", str(CONFIG_64ENV), "--overrides", *LEG_64ENV, *extra,
                        f"runtime.checkpoint_dir={models}", f"runtime.log_dir={logs}",
                        f"train.training_iterations={iterations}"]
                fresh()
                for k in kernels.values():
                    k.launches = 0
                start = time.perf_counter()
                cli.main(argv)
                run = {"seconds": time.perf_counter() - start, "log": dict(log),
                       "launches": {n: k.launches for n, k in kernels.items()}}
                run["latest"] = (models / "LATEST").read_text()
                run["saved"] = load(str(models / f"ckpt_{iterations}"))
                if resume:
                    fresh()
                    for k in kernels.values():
                        k.launches = 0
                    start = time.perf_counter()
                    cli.main(["--resume"] + argv[:-1] + [f"train.training_iterations={total}"])
                    run["resumed"] = {"seconds": time.perf_counter() - start, "log": dict(log),
                                      "launches": {n: k.launches for n, k in kernels.items()}}
                run["rows"] = rows_of(logs)
                results[variant] = run
        finally:
            for owner, attr, fn in originals:
                setattr(owner, attr, fn)

    seq_len = t.sequence_length
    host, overlap, card_actor = (results[v[0]] for v in VARIANTS_64ENV)
    # The host actor: exact broadcasts (gated in unflatten), one before each
    # training round and none inside a round, no kernel in rollout or eval.
    for label, run in (("host actor", host["log"]), ("host actor, resumed",
                                                       host["resumed"]["log"]),
                       ("overlapped", overlap["log"])):
        rounds = run["rounds"]
        if not rounds or not all(r["device"] == "cpu" and r["fresh"] and r["unchanged"]
                                 and not r["mid_round_broadcasts"] for r in rounds):
            fail(f"lifecycle_64env ({label}): a round began on stale weights or the actor "
                 f"changed inside a round: {[(r['fresh'], r['unchanged']) for r in rounds]}")
        steps = [b["broadcasts_before"] for b in rounds]
        if any(b - a != 1 for a, b in zip(steps, steps[1:])):
            fail(f"lifecycle_64env ({label}): broadcasts before each round {steps}, expected "
                 "one between consecutive rounds")
        if any(run["phase"][p][n] for p in run["phase"] for n in kernels) or \
                run["thread_kernels"]:
            fail(f"lifecycle_64env ({label}): the host actor launched {run['phase']} "
                 f"(from the rollout thread: {run['thread_kernels']})")
    for label, launches in (("host actor", host["launches"]),
                            ("resumed", host["resumed"]["launches"])):
        if not all(launches.values()):
            fail(f"lifecycle_64env ({label}): the learner launched {launches}")
    # The card's actor at 64 rows launches the GRU cell and the encoder.
    cphase = card_actor["log"]["phase"]["rollout"]
    if not (cphase["gru_cell"] and cphase["encoder"]) or card_actor["log"]["broadcasts"]:
        fail(f"lifecycle_64env (card actor): rollout launched {cphase}, broadcasts "
             f"{len(card_actor['log']['broadcasts'])}")
    # The resume: iteration, ring, both generators, no reseed.
    saved = host["saved"]
    got = host["resumed"]["log"]["restored"]
    if not (got.get("found") and got["iteration"] == first
            and got["size"] == int(saved["buffer"]["size"])
            and torch.equal(got["rng"], saved["rng"])
            and torch.equal(got["rollout_rng"], saved["rollout_rng"])
            and got["devices"] == ("cuda", "cpu")):
        fail(f"lifecycle_64env: the resume restored iteration {got.get('iteration')}, ring "
             f"{got.get('size')}, generators on {got.get('devices')}, expected iteration "
             f"{first}, ring {int(saved['buffer']['size'])}, the saved generator states on "
             "(cuda, cpu)")
    # The asynchronous saves: each returned before its file landed, LATEST
    # names the newest, and the restored step and weights are the save's.
    saves = host["log"]["saves"]
    timings = saves[-1]["manager"].timings
    if not saves or not all(rec.get("returned_at", 1e30) < rec.get("landed_at", 0)
                            for rec in timings):
        fail(f"lifecycle_64env: an asynchronous save returned after its file landed: "
             f"{timings}")
    if host["latest"] != str(first) or host["resumed"]["log"]["saves"][-1]["step"] != total:
        fail(f"lifecycle_64env: LATEST is {host['latest']}, expected {first}")
    last = saves[-1]
    if (got["state_step"], got["sum"]) != (last["state_step"], last["sum"]):
        fail(f"lifecycle_64env: restored step {got['state_step']} and {last['param']} sum "
             f"{got['sum']}, saved {last['state_step']} and {last['sum']}")
    # The overlap: each overlapped round acted with the weights of before
    # its iteration's update (bf16-rounded, as the wire carries them).
    olog = overlap["log"]
    orounds = [r for r in olog["rounds"] if r["overlapped"]]
    if len(orounds) != first or len(olog["stale"]) != first:
        fail(f"lifecycle_64env (overlapped): {len(orounds)} overlapped rounds, "
             f"{len(olog['stale'])} updates")
    for k, (rnd, before) in enumerate(zip(orounds, olog["stale"]), 1):
        want = [b.to(torch.bfloat16).float() for b in before]
        if not all(torch.equal(a, b) for a, b in zip(rnd["weights"], want)):
            fail(f"lifecycle_64env (overlapped): the round of iteration {k} did not act with "
                 "the weights of before its update")
    if int(overlap["saved"]["buffer"]["size"]) != len(olog["rounds"]) * seq_len:
        fail(f"lifecycle_64env (overlapped): the ring holds "
             f"{int(overlap['saved']['buffer']['size'])} steps an env after "
             f"{len(olog['rounds'])} rounds of {seq_len}")
    # A metrics row for each iteration, finite.
    for variant, run in results.items():
        want_iters = list(range(1, (total if "resumed" in run else first) + 1))
        if [int(row["iteration"]) for row in run["rows"]] != want_iters:
            fail(f"lifecycle_64env ({variant}): metrics rows for "
                 f"{[row['iteration'] for row in run['rows']]}")
        for row in run["rows"]:
            for key in ("wm/loss", "ac/loss_actor", "ac/loss_critic"):
                if not math.isfinite(float(row[key])):
                    fail(f"lifecycle_64env ({variant}): iteration {row['iteration']} {key}")
    for need in (("encoder", 2), ("gru_cell", 1), ("gru_scan", 1), ("imagine_rollout", 1)):
        if len(captured[need[0]]) < need[1]:
            fail(f"lifecycle_64env: the learner gave {need[0]} only {list(captured[need[0]])}")

    def median(run, key):
        vals = [float(row[key]) for row in run["rows"] if row.get(key)]
        return statistics.median(vals) if vals else None

    print(f"lifecycle_64env: cli.train on {CONFIG_64ENV.name} with {' '.join(LEG_64ENV)}: "
          f"64 envs in AsyncEnvFarm, the host actor in float32 on the CPU fed a bf16 "
          f"broadcast, asynchronous checkpoints; runs "
          + ", ".join(f"{v} {results[v]['seconds']:.2f} s" for v in results)
          + f", resumed {host['resumed']['seconds']:.2f} s on {card}", flush=True)
    for variant, run in results.items():
        print(f"lifecycle_64env: {variant}: median perf/env_steps_per_s "
              f"{median(run, 'perf/env_steps_per_s'):.2f}, perf/rollout_s "
              f"{fmt_ms(median(run, 'perf/rollout_s'))}, perf/learner_s "
              f"{fmt_ms(median(run, 'perf/learner_s'))} (s); a policy round "
              f"{statistics.median(run['log']['round_s']):.4f} s, a train_iteration to its "
              f"last kernel {statistics.median(run['log']['learner_s']):.4f} s, an "
              f"AsyncEnvFarm.step of 64 envs {statistics.median(run['log']['farm_ms']):.2f} ms "
              f"(medians); iterations {[row['iteration'] for row in run['rows']]}; launches "
              f"{run['launches']}; in rollout {run['log']['phase']['rollout']}, in eval "
              f"{run['log']['phase']['eval']}", flush=True)
    bms, bmb = host["log"]["bcast_ms"], host["log"]["bcast_mb"]
    print(f"lifecycle_64env: broadcast: {len(bms)} in the first run, median "
          f"{statistics.median(bms):.2f} ms (min {min(bms):.2f}, max {max(bms):.2f}) for "
          f"{bmb[0]:.2f} MB of bf16 (cast, concatenate, one copy to the host, then into the "
          f"actor), each exact; rounds {len(host['log']['rounds'])}, every one on fresh "
          f"weights on {card}", flush=True)
    for rec in timings:
        print(f"lifecycle_64env: asynchronous save of step {rec['step']}: blocked "
              f"{rec['blocking_s'] * 1e3:.2f} ms, wrote {rec['write_s'] * 1e3:.2f} ms "
              f"(ring of {t.buffer_size} steps, {saved['buffer']['obs'].numel() / 1e6:.1f} MB "
              f"of frames) on {card}", flush=True)
    print(f"lifecycle_64env: resume restored iteration {got['iteration']}, a ring of "
          f"{got['size']} steps an env, the learner's cuda and the actor's cpu generator "
          f"states as saved (no reseed), step {got['state_step']}; overlapped rounds acted "
          f"with the weights of before their update; the learner's kernels at this leg's "
          f"shapes: " + ", ".join(f"{n} {sorted(v)}" for n, v in captured.items()), flush=True)
    measure_host_actor_threads(cfg, card)
    kernels_at = hold_at_path(captured, card)
    return host["launches"], host["resumed"]["launches"], kernels_at


def measure_host_actor_threads(cfg, card: str) -> None:
    """The host actor's policy_act_observe at 64 rows on the CPU, in float32,
    at several intra-op thread counts (the default is the host's cores)."""
    import os

    import torch

    from dreamer_tpu_torch.train import Policy

    pol = Policy(cfg.with_override("runtime.compute_dtype=float32"), device="cpu", seed=0)
    n, c = cfg.env.num_envs, cfg.wm
    gen = torch.Generator().manual_seed(5)
    obs = torch.randint(0, 256, (n, *c.obs_size, 3), dtype=torch.uint8, generator=gen)
    h, z = pol.policy_reset(obs, pol.sample_noise(n, gen).gumbel_obs)
    a = torch.zeros(n, cfg.env.action_dim)
    done = torch.zeros(n, dtype=torch.bool)
    default = torch.get_num_threads()
    times = {}
    try:
        for threads in sorted({1, 2, 4, default}):
            torch.set_num_threads(threads)
            pol.policy_act_observe(h, z, a, obs, done, pol.sample_noise(n, gen))
            start = time.perf_counter()
            for _ in range(HOST_ACTOR_STEPS):
                pol.policy_act_observe(h, z, a, obs, done, pol.sample_noise(n, gen))
            times[threads] = (time.perf_counter() - start) / HOST_ACTOR_STEPS * 1e3
    finally:
        torch.set_num_threads(default)
    print(f"lifecycle_64env: host actor policy_act_observe at {n} rows in float32, ms/step by "
          f"intra-op threads (default {default} on {os.cpu_count()} cores): "
          + ", ".join(f"{k}: {v:.2f}" for k, v in times.items()) + f" on {card}", flush=True)


# The data axis: car_racer_64env.yaml with LEG_64ENV's cuts as two ranks of
# runtime.mesh_shape=[2,1] over gloo on the one card (NCCL refuses two ranks
# on one device), each rank a spawned process on cuda:0 with 32 envs in its
# AsyncEnvFarm and 64 of the batch's 128 rows, through cli.train.main with the
# 64-env leg's launch counters; then --resume.  Then one learner iteration of
# the two ranks against one process's n_shards=2 iteration (below).
LEG_2RANK = (*LEG_64ENV, "runtime.mesh_shape=[2,1]")
RANKS = 2
# Seconds a rank may wait in a collective before the group gives up, and
# that the leg waits for its ranks.
RANK_COLLECTIVE_TIMEOUT_S = 180
RANK_JOIN_TIMEOUT_S = 900
# The update check: a ring of 60 steps for each of the 64 envs made from a
# numpy seed (a window of 50 fits), the learner generator's seed, and the
# crafted state under which each of the plan's four collectives changes the
# update: free bits between the two shards' mean KL of the first world-model
# batch (a quarter of the way from the lower), so that a per-rank clamp
# drops one rank's KL gradient; the target critic's output layer scaled up,
# so that the returns' P95 - P05 exceeds 1 and the return scale reads every
# rank's returns; a NaN in every action of rank 1's envs, which must skip
# the update on both ranks.
UPDATE_RING_STEPS = 60
UPDATE_SEED = 11
UPDATE_CRITIC_SCALE = 3.0
# The gradients each optimizer step of the two-rank iteration applies (after
# the all-reduce) against the one-process n_shards=2 iteration's, per tensor
# as the relative L2 distance |g - g_ref| / |g_ref|, the largest over the
# iteration's steps and tensors (those whose norm is at least 1e-6 of their
# step's), and the return scale, relative.  The two differ by bf16 rounding
# only: a rank's weight gradients are bf16 products over its 64 rows,
# rounded before the mean, where the one process rounds a product over 128
# rows once; a bf16 rounding is 2^-9 relative, and the products' K grows
# from 64 to 128.  Measured: 3.4e-3 (world model), 9.1e-5 (actor), 2.1e-3
# (critic), the return scale equal.  Each collective left out moves one of
# them ten times past its tolerance or more (chip_mutants.py's dp_* copies):
# no gradient mean 1.09, free bits per rank 0.51, the return scale from one
# rank's returns 1.2e-2 relative, the NaN skip per rank a changed weight.
UPDATE_GRAD_RTOL = 5e-2
UPDATE_SCALE_RTOL = 1e-3


def _rank_update_check(rank: int) -> dict:
    """One world-model update and one actor-critic update of this rank of
    the two (the group joined), from the crafted state, against one
    process's ``n_shards=2`` updates on rank 0; then the NaN case, a whole
    ``train_iteration``.  Returns what the parent gates."""
    import numpy as np
    import torch

    from dreamer_tpu_torch.config import DreamerConfig
    from dreamer_tpu_torch.parallel import MeshPlan, make_mesh
    from dreamer_tpu_torch.train import agent as agent_mod
    from dreamer_tpu_torch.train import world_model as wm_mod
    from dreamer_tpu_torch.train.step import Trainer

    base = DreamerConfig.from_yaml(str(CONFIG_64ENV), LEG_2RANK)
    E, B, H = base.env.num_envs, base.train.batch_size, base.train.horizon
    plan = MeshPlan(make_mesh(RANKS, 1), "cuda:0")
    rng = np.random.default_rng(UPDATE_SEED)
    (h, w), A = base.wm.obs_size, base.env.action_dim
    data = [rng.integers(0, 256, (E, UPDATE_RING_STEPS, h, w, 3), dtype=np.uint8),
            rng.uniform(-1, 1, (E, UPDATE_RING_STEPS, A)).astype(np.float32),
            rng.normal(0, 1, (E, UPDATE_RING_STEPS)).astype(np.float32),
            (rng.uniform(size=(E, UPDATE_RING_STEPS)) > 0.1).astype(np.float32)]

    def build(cfg, with_plan=True, nan=False):
        p = plan if with_plan else None
        tr = Trainer(cfg, device="cuda:0", seed=cfg.train.seed, plan=p, n_shards=RANKS)
        st = tr.init_state()
        with torch.no_grad():
            for q in st.ac.target_critic.denses[-1].parameters():
                q.mul_(UPDATE_CRITIC_SCALE)
        block = p.env_block(E) if p is not None else slice(None)
        cols = [d.copy() for d in data]
        if nan:
            cols[1][E // RANKS:] = np.nan
        ring = tr.buffer.add_batch(tr.init_ring(), *(
            torch.from_numpy(np.ascontiguousarray(c[block])).to("cuda:0") for c in cols))
        return tr, st, ring

    def flat(st):
        return torch.cat([q.detach().reshape(-1).float() for m in (
            st.wm.nets, st.ac.actor, st.ac.critic, st.ac.target_critic) for q in m.parameters()])

    def gen():
        return torch.Generator(device="cuda:0").manual_seed(UPDATE_SEED)

    # Free bits between the shards' mean KL of the first world-model batch.
    free_bits, kl = 0.0, (0.0, 0.0)
    if rank == 0:
        tr, _, ring = build(base, with_plan=False)
        g = gen()
        batch = tr._sample(ring, g, t_out=H)
        gum = tr.sample_wm_noise(B, g)
        kls = []
        with torch.no_grad():
            for rows in (slice(0, B // RANKS), slice(B // RANKS, B)):
                _, m = wm_mod.wm_loss(tr.rssm, *(b[rows] for b in batch[:4]),
                                      gum[:, rows].contiguous(), base)
                kls.append(float(m["wm/kl_dyn"]))
        kl = tuple(sorted(kls))
        free_bits = kl[0] + 0.25 * (kl[1] - kl[0])
        del tr, ring, batch, gum
    free_bits = plan.broadcast(free_bits)
    # One update of each kind: wm_step and ac_step at one epoch each.
    cfg = base.with_override(f"wm.free_bits={free_bits!r}").with_override(
        "train.wm_epochs=1").with_override("train.ac_epochs=1")

    steps = []
    real = agent_mod.adamw_update

    def adamw(opt, params, grads, state):
        steps.append([g.detach().float().clone() for g in grads])
        return real(opt, params, grads, state)

    def one_of_each(with_plan):
        """One world-model update, then from a fresh state (the initial
        world model) one actor-critic update: the gradients each optimizer
        step applied (world model, actor, critic), the return scale after,
        the WM loss and the updated weights' checksum."""
        tr, st, ring = build(cfg, with_plan)
        st, wm_metrics = tr.wm_step(st, ring, gen())
        wm = flat(st)
        del tr, st, ring
        tr, st, ring = build(cfg, with_plan)
        st, _ = tr.ac_step(st, ring, gen())
        after = torch.cat([wm, flat(st)]).double()
        got = (list(steps), float(st.ac.s_scale), float(wm_metrics["wm/loss"]),
               (float(after.abs().sum()), float(after.square().sum())))
        steps[:] = []
        return got

    agent_mod.adamw_update = wm_mod.adamw_update = adamw
    try:
        calls = plan.calls
        got_steps, s_scale, wm_loss, checksum = one_of_each(True)
        out = {"free_bits": free_bits, "kl": kl, "calls": plan.calls - calls,
               "s_scale": s_scale, "wm/loss": wm_loss, "checksum": checksum}
        tr, st, ring = build(cfg, nan=True)
        before = flat(st)
        st, m = tr.train_iteration(st, ring, gen())
        steps[:] = []
        out["nan_unchanged"] = bool(torch.equal(before, flat(st)))
        out["nan_skipped"] = (float(m["wm/update_skipped"]), float(m["ac/update_skipped"]))
        del tr, st, ring
        if rank == 0:
            ref_steps, ref_s_scale, ref_wm_loss, _ = one_of_each(False)
            per_step = []
            for got, ref in zip(got_steps, ref_steps, strict=True):
                norms = [float(r.norm()) for r in ref]
                top = max(norms)
                per_step.append(max(float((g - r).norm()) / n
                                    for g, r, n in zip(got, ref, norms) if n >= 1e-6 * top))
            out.update(grad_gap=max(per_step), grad_gap_by_step=per_step,
                       ref_s_scale=ref_s_scale, ref_wm_loss=ref_wm_loss,
                       n_steps=len(got_steps))
    finally:
        agent_mod.adamw_update = wm_mod.adamw_update = real
    return out


def _rank_env(rank: int, port: int) -> None:
    """torchrun's variables for rank ``rank`` of ``RANKS`` on this host."""
    import os

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(RANKS),
                      LOCAL_WORLD_SIZE=str(RANKS), MASTER_ADDR="localhost",
                      MASTER_PORT=str(port), DREAMER_DIST_TIMEOUT_S=str(RANK_COLLECTIVE_TIMEOUT_S))
    # As torchrun would: the host's cores shared out, not each rank on all of them.
    os.environ.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or RANKS) // RANKS)))


def spawn_ranks(target, label: str, tmp: str):
    """``target(rank, port, tmp)`` in ``RANKS`` spawned processes; each
    writes ``tmp/rank{rank}.pt``, a dict with "error" if it raised.
    Returns the dicts and the seconds the ranks took."""
    import multiprocessing
    import socket

    import torch

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = multiprocessing.get_context("spawn")
    start = time.perf_counter()
    procs = [ctx.Process(target=target, args=(r, port, tmp), name=f"rank-{r}")
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_JOIN_TIMEOUT_S)
    hung = [p.name for p in procs if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    seconds = time.perf_counter() - start
    if hung:
        fail(f"{label}: {hung} did not finish within {RANK_JOIN_TIMEOUT_S} s")
    results = [torch.load(f"{tmp}/rank{r}.pt", weights_only=False) for r in range(RANKS)]
    for res in results:
        if "error" in res:
            fail(f"{label}: rank {res['rank']} raised:\n{res['error']}")
    return results, seconds


def _rank_update_main(rank: int, port: int, tmp: str) -> None:
    """One rank of ``run_update_check``: joins the gloo group on cuda:0 and
    runs ``_rank_update_check``; writes ``tmp/rank{rank}.pt``."""
    import traceback

    _rank_env(rank, port)
    import torch

    from dreamer_tpu_torch.parallel import distributed

    result = {"rank": rank}
    try:
        distributed.init_distributed("gloo", "cuda:0")
        result["update"] = _rank_update_check(rank)
    except BaseException:   # noqa: BLE001 - reported by the parent, which fails
        result["error"] = traceback.format_exc()
    finally:
        torch.save(result, f"{tmp}/rank{rank}.pt")
        distributed.shutdown()


def run_update_check(card: str):
    """One learner iteration of two ranks on the card (gloo, each cuda:0)
    against one process's n_shards=2 iteration, from the crafted state of
    ``_rank_update_check``; then the NaN case.  Prints the readings and
    returns (rank 0's, rank 1's, the list of what failed)."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        results, seconds = spawn_ranks(_rank_update_main, "update check", tmp)
    u0, u1 = (res["update"] for res in results)
    failures = []
    if u0["checksum"] != u1["checksum"]:
        failures.append("after one iteration the ranks' parameters differ")
    lo, hi = u0["kl"]
    if not lo < u0["free_bits"] < (lo + hi) / 2:
        failures.append(f"free bits {u0['free_bits']} not between the shards' mean KL {lo} "
                        f"and {hi}")
    scale_gap = abs(u0["s_scale"] - u0["ref_s_scale"]) / u0["ref_s_scale"]
    if u0["grad_gap"] > UPDATE_GRAD_RTOL:
        failures.append(f"gradients {u0['grad_gap']:.3e} from one process's")
    if scale_gap > UPDATE_SCALE_RTOL:
        failures.append(f"return scale {scale_gap:.3e} from one process's")
    if not (u0["nan_unchanged"] and u1["nan_unchanged"]
            and u0["nan_skipped"] == u1["nan_skipped"] == (1.0, 1.0)):
        failures.append("a NaN on rank 1 did not skip the update on both ranks")
    print(f"update check: one world-model and one actor-critic update of 2 ranks (gloo, one "
          f"card) against one process's n_shards=2 updates in bf16 at {CONFIG_64ENV.name}'s "
          f"widths (batch 128), free bits {u0['free_bits']:.4f} between the shards' mean KL {lo:.4f} and "
          f"{hi:.4f}, the target critic's output x{UPDATE_CRITIC_SCALE}: gradients of "
          f"{u0['n_steps']} optimizer steps (world model, actor, critic), largest relative L2 "
          f"gap of a tensor "
          f"{u0['grad_gap']:.3e} (by step {[f'{g:.2e}' for g in u0['grad_gap_by_step']]}; "
          f"tolerance {UPDATE_GRAD_RTOL}); return scale {u0['s_scale']:.6g} against "
          f"{u0['ref_s_scale']:.6g} (rel {scale_gap:.2e}, tolerance {UPDATE_SCALE_RTOL}); "
          f"wm/loss {u0['wm/loss']:.6g} against {u0['ref_wm_loss']:.6g}; {u0['calls']} "
          f"collectives; a NaN in rank 1's actions: skipped (wm, ac) {u0['nan_skipped']} and "
          f"{u1['nan_skipped']}, weights unchanged {u0['nan_unchanged']} and "
          f"{u1['nan_unchanged']}; {seconds:.2f} s with the spawn; "
          f"{'; '.join(failures) or 'held'} on {card}", flush=True)
    return u0, u1, failures


def _rank_main(rank: int, port: int, tmp: str) -> None:
    """One rank of ``run_two_rank_lifecycle``: torchrun's variables, the
    launch counters and timers of the 64-env leg, then ``cli.train.main``
    twice (train, then ``--resume``).  Writes its findings (and any error)
    to ``tmp/rank{rank}.pt`` and the kernels' operands at its learner's
    shapes to ``tmp/operands{rank}.pt``."""
    import traceback

    _rank_env(rank, port)
    import functools
    import types

    import torch

    from dreamer_tpu_torch.cli import train as cli
    from dreamer_tpu_torch.config import DreamerConfig
    from dreamer_tpu_torch.envs import EnvFarm, FakeEnv
    from dreamer_tpu_torch.nets import gru, wm_nets
    from dreamer_tpu_torch.ops import conv_cuda, gru_cuda, gru_scan_cuda, imagine_scan, observe_scan
    from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
    from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout
    from dreamer_tpu_torch.orchestrator import dreamer as orch
    from dreamer_tpu_torch.parallel import distributed
    from dreamer_tpu_torch.train import step as train_step

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = DreamerConfig.from_yaml(str(CONFIG_64ENV), LEG_2RANK)
    rows = cfg.train.batch_size // RANKS
    kernels = {"gru_cell": gru_cuda.gru_cell, "gru_scan": gru_scan,
               "encoder": conv_cuda.encoder_forward, "imagine_rollout": imagine_rollout}
    real = {"collect": orch.Dreamer._collect_chunk, "eval": orch.Dreamer._evaluate_batched,
            "restore": orch.Dreamer.restore_latest, "close": orch.Dreamer.close,
            "iteration": train_step.Trainer.train_iteration, "cell": gru.gru_cell,
            "encode": wm_nets.encode, "imagine": imagine_scan.imagine_rollout}
    log, captured, result = {}, {name: {} for name in kernels}, {"rank": rank}

    def keep(name, key, operands):
        if key not in captured[name]:
            captured[name][key] = tuple(o.clone() if isinstance(o, torch.Tensor) else
                                        [w.clone() for w in o] if isinstance(o, (list, tuple))
                                        else o for o in operands)

    def cell(x, h, *w):
        if x.is_cuda and x.shape[0] == rows:
            keep("gru_cell", rows, (x, h, list(w)))
        return real["cell"](x, h, *w)

    def encode(obs, table, operands, params):
        if obs.is_cuda and obs.shape[0] >= rows:
            keep("encoder", obs.shape[0], (obs, table, *operands))
        return real["encode"](obs, table, operands, params)

    def scan(xs, h0, *ops):
        if xs.is_cuda:
            keep("gru_scan", tuple(xs.shape[:2]), (xs, h0, list(ops)))
        return gru_scan_cuda.gru_scan(xs, h0, *ops)

    scan_module = types.SimpleNamespace(**{**vars(gru_scan_cuda), "gru_scan": scan})

    def imagine(h0, z0, eps, gum, weights, unimix, min_std):
        if h0.is_cuda:
            keep("imagine_rollout", tuple(eps.shape[:2]),
                 (h0, z0, eps, gum, list(weights), unimix, min_std))
        return real["imagine"](h0, z0, eps, gum, weights, unimix, min_std)

    def collect(self, random_policy):
        before = {n: k.launches for n, k in kernels.items()}
        start = time.perf_counter()
        out = real["collect"](self, random_policy)
        if not random_policy:
            log["rollout_s"].append(time.perf_counter() - start)
        log["envs"] = self.farm.num_envs
        for n, k in kernels.items():
            log["actor_launches"][n] += k.launches - before[n]
        return out

    def evaluate(self, episodes, max_steps):
        if self._eval_farm is None:
            self._eval_farm = EnvFarm(
                [functools.partial(FakeEnv, obs_size=tuple(self.cfg.wm.obs_size), episode_len=n)
                 for n in EVAL_64ENV_STEPS], seed=self._eval_seed)
        log["evals"] += 1
        before = {n: k.launches for n, k in kernels.items()}
        out = real["eval"](self, episodes, max_steps)
        for n, k in kernels.items():
            log["actor_launches"][n] += k.launches - before[n]
        return out

    def iteration(self, state, ring, generator, nu=None):
        torch.cuda.synchronize()
        start, coll = time.perf_counter(), self.plan.seconds
        out = real["iteration"](self, state, ring, generator, nu)
        torch.cuda.synchronize()
        log["learner_s"].append(time.perf_counter() - start)
        updates = self.cfg.train.wm_epochs + self.cfg.train.ac_epochs
        log["collective_s"].append((self.plan.seconds - coll) / updates)
        return out

    def restore(self):
        found = real["restore"](self)
        log["restored"] = {"found": found, "iteration": self.iteration, "size": self.buf.size}
        return found

    def close(self):
        params = torch.cat([p.detach().reshape(-1).double() for m in (
            self.state.wm.nets, self.state.ac.actor, self.state.ac.critic,
            self.state.ac.target_critic) for p in m.parameters()])
        log.update(checksum=(float(params.abs().sum()), float(params.square().sum())),
                   iteration=self.iteration, metrics_enabled=self.metrics.enabled,
                   csv_opened=self.metrics._csv_file is not None, ring=tuple(self.buf.obs.shape),
                   global_envs=self.n_envs_global, plan_calls=self.plan.calls)
        return real["close"](self)

    patches = ((orch.Dreamer, "_collect_chunk", collect),
               (orch.Dreamer, "_evaluate_batched", evaluate),
               (orch.Dreamer, "restore_latest", restore), (orch.Dreamer, "close", close),
               (train_step.Trainer, "train_iteration", iteration), (gru, "gru_cell", cell),
               (wm_nets, "encode", encode), (observe_scan, "gru_scan_cuda", scan_module),
               (imagine_scan, "imagine_rollout", imagine))
    for owner, attr, fn in patches:
        setattr(owner, attr, fn)
    first, total = ITERATIONS_64ENV
    argv = ["--config", str(CONFIG_64ENV), "--device", "cuda:0", "--dist-backend", "gloo",
            "--overrides", *LEG_2RANK, f"runtime.checkpoint_dir={tmp}/models",
            f"runtime.log_dir={tmp}/logs"]
    try:
        for run, extra in (("first", [f"train.training_iterations={first}"]),
                           ("resumed", [f"train.training_iterations={total}"])):
            log.clear()
            log.update(rollout_s=[], learner_s=[], collective_s=[], evals=0,
                       actor_launches=dict.fromkeys(kernels, 0))
            for k in kernels.values():
                k.launches = 0
            start = time.perf_counter()
            cli.main((["--resume"] if run == "resumed" else []) + argv + extra)
            result[run] = {**log, "seconds": time.perf_counter() - start,
                           "launches": {n: k.launches for n, k in kernels.items()},
                           "backend": torch.distributed.get_backend()}
        torch.save(captured, f"{tmp}/operands{rank}.pt")
    except BaseException:   # noqa: BLE001 - reported by the parent, which fails
        result["error"] = traceback.format_exc()
    finally:
        torch.save(result, f"{tmp}/rank{rank}.pt")
        distributed.shutdown()


def run_two_rank_lifecycle(card: str):
    """The data axis on the card: ``_rank_main`` on two spawned ranks (each
    on cuda:0, gloo), then their findings gated here: each rank's learner
    launched all four kernels and its host actor none; the ranks' parameters
    equal after each run; the resume restored iteration 2; rank 0 alone
    wrote metrics and evaluated; every rank wrote its checkpoint shard.
    Then ``run_update_check`` (two more ranks), and each kernel held against
    its plain version at each rank's operands.  Returns each rank's
    launches and rank 0's kernel numbers."""
    import csv
    import os
    import tempfile

    import torch

    with tempfile.TemporaryDirectory() as tmp:
        results, seconds = spawn_ranks(_rank_main, "lifecycle_64env_2rank", tmp)
        operands = [torch.load(f"{tmp}/operands{r}.pt", map_location="cuda:0",
                               weights_only=False) for r in range(RANKS)]
        rows = []
        for name in ("metrics.leg1.csv", "metrics.csv"):
            with open(f"{tmp}/logs/{name}") as f:
                rows += [row for row in csv.DictReader(f) if row.get("wm/loss")]
        shards = sorted(n for n in os.listdir(f"{tmp}/models") if ".rank" in n)

    first, total = ITERATIONS_64ENV
    for run in ("first", "resumed"):
        a, b = (res[run] for res in results)
        for res in results:
            r = res[run]
            if not all(r["launches"].values()) or any(r["actor_launches"].values()):
                fail(f"lifecycle_64env_2rank ({run}): rank {res['rank']}'s learner launched "
                     f"{r['launches']}, its host actor {r['actor_launches']}")
            if r["envs"] != 32 or r["global_envs"] != 64 or r["ring"][0] != 32:
                fail(f"lifecycle_64env_2rank ({run}): rank {res['rank']} stepped {r['envs']} "
                     f"envs of {r['global_envs']} into a ring of {r['ring']}")
            if r["backend"] != "gloo":
                fail(f"lifecycle_64env_2rank: the ranks joined over {r['backend']}")
        if a["checksum"] != b["checksum"]:
            fail(f"lifecycle_64env_2rank ({run}): the ranks' parameters differ: checksums "
                 f"{a['checksum']} and {b['checksum']}")
        if not (a["metrics_enabled"] and a["csv_opened"]) or b["metrics_enabled"] \
                or b["csv_opened"] or not a["evals"] or b["evals"]:
            fail(f"lifecycle_64env_2rank ({run}): metrics written by rank 0 "
                 f"{a['csv_opened']}, rank 1 {b['csv_opened']}; evals {a['evals']}, {b['evals']}")
    for res in results:
        got = res["resumed"].get("restored", {})
        if not got.get("found") or got["iteration"] != first or res["resumed"]["iteration"] != total:
            fail(f"lifecycle_64env_2rank: rank {res['rank']} resumed at {got} and ended at "
                 f"{res['resumed']['iteration']}, expected {first} then {total}")
    if [int(row["iteration"]) for row in rows] != list(range(1, total + 1)):
        fail(f"lifecycle_64env_2rank: metrics rows {[row['iteration'] for row in rows]}")
    if shards[-RANKS:] != [f"ckpt_{total}.rank{r}" for r in range(RANKS)]:
        fail(f"lifecycle_64env_2rank: the checkpoint's shards are {shards}")

    # The update: two ranks against one process, and the NaN skip.
    failures = run_update_check(card)[2]
    if failures:
        fail(f"lifecycle_64env_2rank: the update check: {'; '.join(failures)}")

    def median(values):
        return statistics.median(values) if values else float("nan")

    steps = [float(row["perf/env_steps_per_s"]) for row in rows]
    print(f"lifecycle_64env_2rank: cli.train on {CONFIG_64ENV.name} with {' '.join(LEG_2RANK)} "
          f"as 2 ranks on one card over gloo (each cuda:0, 32 envs in AsyncEnvFarm, 64 rows of "
          f"the 128), then --resume: {seconds:.2f} s for the leg with its spawn; global median "
          f"perf/env_steps_per_s {median(steps):.2f} (rank 0's rows); gloo took CUDA tensors "
          f"for every collective of the plan in torch {torch.__version__} on {card}", flush=True)
    for res in results:
        for run in ("first", "resumed"):
            r = res[run]
            print(f"lifecycle_64env_2rank: rank {res['rank']} ({run}, {r['seconds']:.2f} s): "
                  f"median perf/learner_s {median(r['learner_s']):.4f}, perf/rollout_s "
                  f"{median(r['rollout_s']):.4f}, in collectives {median(r['collective_s']):.4f} "
                  f"s an update; learner launches {r['launches']}, host actor "
                  f"{r['actor_launches']}; evals {r['evals']}", flush=True)
    for r, ops in enumerate(operands):
        for name, need in (("encoder", 2), ("gru_cell", 1), ("gru_scan", 1),
                           ("imagine_rollout", 1)):
            if len(ops[name]) < need:
                fail(f"lifecycle_64env_2rank: rank {r}'s learner gave {name} only {list(ops[name])}")
    kernels_at = [hold_at_path(ops, card, f"lifecycle_64env_2rank rank {r}")
                  for r, ops in enumerate(operands)]
    launches = [{n: res["first"]["launches"][n] + res["resumed"]["launches"][n]
                 for n in res["first"]["launches"]} for res in results]
    return launches, kernels_at[0]


def check_nccl_world_one(card: str) -> None:
    """The plan's collectives through NCCL, the backend of one card a rank,
    in a group of one rank on this card: all-reduce (``sum``,
    ``reduce_update``, ``mean_metrics``), all-gather (``gather``),
    ``broadcast`` and ``barrier``; each result the identity's."""
    import os
    import socket

    import torch
    import torch.distributed as dist

    from dreamer_tpu_torch.parallel import MeshPlan, make_mesh

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {"MASTER_ADDR": "localhost", "MASTER_PORT": str(port)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    dist.init_process_group("nccl", rank=0, world_size=1, device_id=torch.device("cuda:0"))
    try:
        plan = MeshPlan(make_mesh(1, 1), "cuda:0")
        x = torch.randn(5, 3, device="cuda:0")
        grads, finite = plan.reduce_update([x, x[0]], torch.tensor(True, device="cuda:0"))
        metrics = plan.mean_metrics({"a": x.sum(), "b": x[1]})
        ok = (plan.active and dist.get_backend() == "nccl"
              and torch.equal(plan.sum(x), x) and torch.equal(grads[0], x)
              and torch.equal(grads[1], x[0]) and bool(finite)
              and torch.equal(plan.gather(x), x) and torch.equal(metrics["b"], x[1])
              and plan.broadcast(2.5) == 2.5)
        plan.barrier()
        if not ok or plan.calls != 6:
            fail(f"nccl: the plan's collectives in a group of one ({plan.calls} calls)")
        print(f"nccl: all-reduce, all-gather, broadcast and barrier through MeshPlan in a "
              f"one-rank NCCL group, each the identity ({plan.calls} collectives, "
              f"{plan.seconds * 1e3:.2f} ms) on {card}", flush=True)
    finally:
        dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def kernel_faults():
    """Faulty kernels whose card-vs-CPU readings ``check_ac_update_vs_cpu``
    prints beside the right kernels' reading: (name, module, the name the
    path calls, wrap).  Each wrap turns the wrapper into one that launches
    the kernel on wrong operands."""
    import torch

    from dreamer_tpu_torch.nets import gru, wm_nets
    from dreamer_tpu_torch.ops import imagine_scan

    return (
        ("imagine kernel without unimix", imagine_scan, "imagine_rollout",
         lambda f: lambda h0, z0, eps, gum, w, unimix, min_std: f(h0, z0, eps, gum, w, 0.0,
                                                                   min_std)),
        ("encoder kernel without its biases", wm_nets, "encode",
         lambda f: lambda x, table, ops, params: f(
             x, table, (ops[0], [torch.zeros_like(b) for b in ops[1]]), params)),
        ("GRU cell kernel without its hidden bias", gru, "gru_cell",
         lambda f: lambda x, h, wi, wh, bi, bh: f(x, h, wi, wh, bi, torch.zeros_like(bh))),
    )


def check_ac_update_vs_cpu(cfg, card: str) -> None:
    """One ac_update on the card and on the CPU (plain versions), from the
    same seeded weights (the parameters the init leaves zero drawn), batch and
    noise, in bf16 on both, held to AC_CARD_VS_CPU_RTOL; then, for the
    record of what this check can see, the same on the card with each of
    ``kernel_faults``."""
    import torch

    from dreamer_tpu_torch.core.dists import sample_gumbel
    from dreamer_tpu_torch.train import ACNoise

    c, t = cfg.wm, cfg.train
    B, Tw = t.batch_size, t.sequence_length // 2
    lat = (B, c.latent_rows, c.latent_classes)
    gen = torch.Generator().manual_seed(9)
    noise = ACNoise(sample_gumbel((Tw, *lat), gen, "cpu"),
                    torch.randn(t.horizon, B, cfg.env.action_dim, generator=gen),
                    sample_gumbel((t.horizon, *lat), gen, "cpu"))

    def update(device):
        trainer, ring = flagship_trainer(cfg, device)
        state = trainer.init_state().ac
        draw_zero_params([state.actor, trainer.rssm.nets], torch.Generator().manual_seed(6))
        draws = torch.Generator().manual_seed(10)
        hi = trainer.buffer.valid_starts(ring)
        env_idx, starts = trainer.buffer.pick_indices(ring, *(
            torch.randint(0, n, (B,), generator=draws).to(device)
            for n in (trainer.buffer.num_envs, hi, hi)))
        batch = trainer.buffer.gather(ring, env_idx, starts, Tw, with_scalars=False)
        start = time.perf_counter()
        _, metrics = trainer.agent.ac_update(state, trainer.rssm, batch,
                                             ACNoise(*(n.to(device) for n in noise)))
        metrics = {k: float(v) for k, v in metrics.items()}
        print(f"ac_update: one update on {device} in {time.perf_counter() - start:.2f} s",
              flush=True)
        return metrics

    gated = ("ac/loss_actor", "ac/loss_critic", "ac/grad_norm_actor", "ac/grad_norm_critic")

    def worst_rel(got, ref, label):
        rels = {k: abs(got[k] - ref[k]) / max(abs(ref[k]), 1e-6) for k in gated}
        for k, rel in rels.items():
            print(f"ac_update: {label} {k}: {got[k]:.6g} cpu {ref[k]:.6g} rel {rel:.3e}",
                  flush=True)
        return max(rels.values())

    ref = update("cpu")
    got = update("cuda")
    for k in ref:
        if k not in gated:
            print(f"ac_update: card vs cpu {k}: card {got[k]:.6g} cpu {ref[k]:.6g}", flush=True)
    worst = worst_rel(got, ref, "card vs cpu")
    faulty = {}
    for name, module, attr, wrap in kernel_faults():
        right = getattr(module, attr)
        setattr(module, attr, wrap(right))
        try:
            faulty[name] = worst_rel(update("cuda"), ref, f"card with {name} vs cpu")
        finally:
            setattr(module, attr, right)
    readings = ", ".join(f"{n} {v:.3e}" for n, v in faulty.items())
    print(f"ac_update: card vs cpu, worst relative difference of the losses and gradient "
          f"norms {worst:.3e} (tolerance {AC_CARD_VS_CPU_RTOL}, a sanity check); with a "
          f"faulty kernel, not gated: {readings} on {card}", flush=True)
    if worst > AC_CARD_VS_CPU_RTOL:
        fail(f"ac_update: card vs cpu differ by {worst:.3e} rel (tolerance "
             f"{AC_CARD_VS_CPU_RTOL})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from dreamer_tpu_torch.config import DreamerConfig
        from dreamer_tpu_torch.ops import cuda_build
        from dreamer_tpu_torch.ops.conv_cuda import encoder_forward
        from dreamer_tpu_torch.ops.gru_cuda import gru_cell
        from dreamer_tpu_torch.ops.gru_scan_cuda import gru_scan
        from dreamer_tpu_torch.ops.imagine_cuda import imagine_rollout
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    # f32 references stay f32: no TF32 in cuDNN or matmuls.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    print(card, flush=True)  # exactly as nvidia-smi gives it

    start = time.perf_counter()
    lib = cuda_build.build()
    print(f"build: {lib.relative_to(ROOT)} in {time.perf_counter() - start:.2f} s", flush=True)
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            print(f"build: {line.strip()}", flush=True)

    cfg = DreamerConfig.from_yaml(str(CONFIG))
    if cfg.runtime.compute_dtype != "bfloat16":
        fail(f"{CONFIG.name} computes in {cfg.runtime.compute_dtype}; the kernels take bf16")
    kernels = [check_gru(cfg, card), check_gru_scan(cfg, card), check_encoder(cfg, card),
               check_imagine(cfg, card)]
    counted = (gru_cell, gru_scan, encoder_forward, imagine_rollout)
    names = ("gru_cell", "gru_scan", "encoder", "imagine_rollout")

    check_policy_vs_cpu(cfg)
    from dreamer_tpu_torch.train import Policy

    policy = Policy(cfg, seed=0)
    for k in counted:
        k.launches = 0
    run_policy(policy, cfg, card)
    on_policy = {n: k.launches for n, k in zip(names, counted)}
    for name in ("gru_cell", "encoder"):
        if on_policy[name] == 0:
            fail(f"the policy path never launched {name}")
    profile_policy(policy, cfg, card)

    on_ac = run_ac_step(cfg, card)
    for name in ("gru_cell", "encoder", "imagine_rollout"):
        if on_ac[name] == 0:
            fail(f"the ac_step path never launched {name}")
    check_ac_update_vs_cpu(cfg, card)

    # This slice's main path, Trainer.train_iteration: every kernel.
    on_iteration = run_train_iteration(cfg, card)
    for k in kernels:
        if on_iteration[k["name"]] == 0:
            fail(f"the train_iteration path never launched {k['name']}")
        # The line's count is the main path's; each path's count is kept beside it.
        k["launches"] = on_iteration[k["name"]]
        k["launches_by_path"] = {"policy": on_policy[k["name"]],
                                 "ac_step": on_ac[k["name"]],
                                 "train_iteration": on_iteration[k["name"]]}
    check_wm_update_vs_cpu(cfg, card)

    # The training lifecycle through the CLI: every kernel again.
    on_lifecycle, one_env = run_lifecycle(cfg, card)
    for k in kernels:
        if on_lifecycle[k["name"]] == 0:
            fail(f"the lifecycle path never launched {k['name']}")
        k["launches_by_path"]["lifecycle"] = on_lifecycle[k["name"]]

    # The lifecycle with a real env's wrapper stack in spawned env workers.
    on_async = run_async_lifecycle(cfg, card, one_env)
    for k in kernels:
        if on_async[k["name"]] == 0:
            fail(f"the async lifecycle path never launched {k['name']}")
        k["launches_by_path"]["lifecycle_async"] = on_async[k["name"]]

    # car_racer_64env.yaml: the host actor, the overlap, the card's actor; each
    # kernel held at the 64-env learner's shapes.
    on_64env, on_64env_resumed, at_64env = run_actor_learner_lifecycle(card)
    for k in kernels:
        n = on_64env[k["name"]] + on_64env_resumed[k["name"]]
        if n == 0:
            fail(f"the 64-env lifecycle path never launched {k['name']}")
        k["launches_by_path"]["lifecycle_64env"] = n
        for shape, tm in at_64env[k["name"]].items():
            if shape == "max_abs_err":
                k["max_abs_err_at_64env"] = tm
                continue
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                k[f"{key}_at_64env_{shape.replace(' ', '_')}"] = tm[key]

    # The data axis: car_racer_64env.yaml as two ranks on the card over gloo;
    # each kernel launched by both ranks' learners and held at their operands.
    on_2rank, at_2rank = run_two_rank_lifecycle(card)
    for k in kernels:
        for r, launches in enumerate(on_2rank):
            if launches[k["name"]] == 0:
                fail(f"the 2-rank lifecycle's rank {r} never launched {k['name']}")
            k["launches_by_path"][f"lifecycle_64env_2rank_rank{r}"] = launches[k["name"]]
        for shape, tm in at_2rank[k["name"]].items():
            if shape == "max_abs_err":
                k["max_abs_err_at_2rank"] = tm
                continue
            for key in ("ms", "plain_ms", "library_ms", "bound_ms"):
                k[f"{key}_at_2rank_{shape.replace(' ', '_')}"] = tm[key]
    check_nccl_world_one(card)

    # Times at the main path's shapes: the GRU cell at 50 rows, the whole-scan
    # GRU at T 1 x 1500, the encoder at 1500 frames, the imagination at B 50,
    # T 30; a kernel's other shapes are on its "kernels:" lines and as extra keys.
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{**{k: kern[k] for k in keys},
                                   **{k: v for k, v in kern.items() if k not in keys}}
                                  for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
