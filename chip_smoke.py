#!/usr/bin/env python3
"""Drive the PyTorch port (dreamer_tpu_torch) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its lines; any failure exits non-zero:

1. card:    the card's name and power limit, as nvidia-smi prints them.
2. build:   compile the CUDA kernels under dreamer_tpu_torch/csrc with nvcc.
3. kernels: each kernel against its plain PyTorch version on the card, in
            bf16 at the flagship shapes (N = 1, 50, 64 rows or frames), with
            its time beside the plain version's, one library call's and the
            least time the card could take (its bound).
4. policy:  the serving path, Policy.policy_reset then policy_act_observe
            steps with a reset row partway, at the flagship widths of
            configs/car_racer.yaml (read by the port's own YAML reader) with
            weights drawn from a seed, for N = 1 and N = 64 envs; checks the
            outputs, that every step launched each kernel once, and one step
            against the plain versions on the CPU.  Prints ms/step.
5. profile: torch.profiler over a few steps: the device's busy share of a
            step and the kernels that take the most device time.
6. the "kernels" JSON line, then the result line.

It needs a CUDA device and imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "car_racer.yaml"

# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# HBM bandwidth and dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

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


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(out, ref, tolerance, name: str) -> float:
    """Max |out - ref|; fails unless every element is within
    ``tolerance(ref)``.  Prints the error beside the tolerance and the
    reference's rms and max, so that a reader sees the tolerance is below the
    size of what it compares."""
    import torch

    out, ref = out.float(), ref.float()
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
    import torch

    from dreamer_tpu_torch.nets.gru import GRUCell
    from dreamer_tpu_torch.ops.gru_cuda import gru_cell, gru_cell_plain, tolerance

    H = cfg.wm.hidden_dim
    I = cfg.wm.latent_dim + cfg.env.action_dim
    gen = torch.Generator().manual_seed(1)
    cell = GRUCell(I, H, torch.bfloat16, gen).cuda()
    wi_t, wh_t, bi, bh = cell.kernel_weights()
    worst, times = 0.0, {}
    for n in (1, 50, 64):
        x = torch.randn(n, I, generator=gen).to("cuda", torch.bfloat16)
        h = torch.randn(n, H, generator=gen).clamp(-1, 1).to("cuda", torch.bfloat16)
        out = gru_cell(x, h, wi_t, wh_t, bi, bh)
        torch.cuda.synchronize()
        ref = gru_cell_plain(x, h, wi_t, wh_t, bi, bh)
        worst = max(worst, max_err(out, ref, tolerance, f"kernels: gru_cell N={n}"))
        if n in (1, 64):
            # The library yardstick: torch.gru_cell has the same semantics.
            w_ih = cell.kernel_i.detach().t().contiguous().to(torch.bfloat16)
            w_hh = cell.kernel_h.detach().t().contiguous().to(torch.bfloat16)
            b_ih = cell.bias_i.detach().to(torch.bfloat16)
            b_hh = cell.bias_h.detach().to(torch.bfloat16)
            t = {"ms": cuda_ms(lambda: gru_cell(x, h, wi_t, wh_t, bi, bh), 200),
                 "plain_ms": cuda_ms(lambda: gru_cell_plain(x, h, wi_t, wh_t, bi, bh), 200),
                 "library_ms": cuda_ms(lambda: torch.gru_cell(x, h, w_ih, w_hh, b_ih, b_hh), 200)}
            # x, h and the out in bf16; the unpadded gate weights (I + H, 3H)
            # and the biases, which the flax cell rounds to bf16.
            nbytes = 2 * (n * I + n * H + 3 * H * (I + H) + n * H) + 2 * 6 * H
            t["bound_ms"], t["bound_by"] = bound_ms(nbytes, 2 * n * 3 * H * (I + H))
            times[n] = t
            print(f"kernels: gru_cell N={n} kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
                  f"({t['bound_by']}) on {card}", flush=True)
    return {"name": "gru_cell", "route": "cuda", "source": "dreamer_tpu_torch/csrc/gru_cell.cu",
            "replaces": "dreamer_tpu/ops/gru_pallas.py:111", "max_abs_err": worst,
            **times[64]}


def check_encoder(cfg, card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from dreamer_tpu_torch.nets.wm_nets import WMNets
    from dreamer_tpu_torch.ops.conv_cuda import (encoder_forward, encoder_forward_plain,
                                                 tolerance)

    gen = torch.Generator().manual_seed(2)
    nets = WMNets(cfg.wm, cfg.env.action_dim, torch.bfloat16, gen)
    draw_zero_params([nets], gen)
    nets = nets.cuda()
    ws, bs = nets.encoder_weights()
    oihw = [c.weight.detach().to(torch.bfloat16) for c in nets.enc_convs]
    bias16 = [c.bias.detach().to(torch.bfloat16) for c in nets.enc_convs]
    Hf, Wf = cfg.wm.obs_size
    worst, times = 0.0, {}
    for n in (1, 50, 64):
        obs = torch.randint(0, 256, (n, Hf, Wf, 3), dtype=torch.uint8, generator=gen).cuda()
        out = encoder_forward(obs, ws, bs)
        torch.cuda.synchronize()
        ref = encoder_forward_plain(obs, ws, bs)
        worst = max(worst, max_err(out, ref, tolerance, f"kernels: encoder N={n}"))
        if n in (1, 64):
            def library():
                # The cuDNN yardstick: four bf16 conv2d + SiLU, NHWC out.
                x = (obs.float() / 255.0 - 0.5).to(torch.bfloat16).permute(0, 3, 1, 2)
                for w, b in zip(oihw, bias16):
                    x = F.silu(F.conv2d(x, w, b, stride=2, padding=1))
                return x.permute(0, 2, 3, 1).reshape(n, -1)

            t = {"ms": cuda_ms(lambda: encoder_forward(obs, ws, bs), 20),
                 "plain_ms": cuda_ms(lambda: encoder_forward_plain(obs, ws, bs), 20),
                 "library_ms": cuda_ms(library, 20)}
            flops, cin, hw = 0, 3, Hf * Wf
            for w in ws:
                hw //= 4
                flops += 2 * n * hw * w.shape[3] * 16 * cin
                cin = w.shape[3]
            nbytes = obs.numel() + 2 * (sum(w.numel() for w in ws) + out.numel()) \
                + 4 * sum(b.numel() for b in bs)
            t["bound_ms"], t["bound_by"] = bound_ms(nbytes, flops)
            times[n] = t
            print(f"kernels: encoder N={n} kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                  f"library_ms={t['library_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
                  f"({t['bound_by']}) on {card}", flush=True)
    return {"name": "encoder", "route": "cuda", "source": "dreamer_tpu_torch/csrc/encoder.cu",
            "replaces": "dreamer_tpu/ops/conv_pallas.py:144", "max_abs_err": worst,
            **times[64]}


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
    kernels = [check_gru(cfg, card), check_encoder(cfg, card)]

    check_policy_vs_cpu(cfg)
    from dreamer_tpu_torch.train import Policy

    policy = Policy(cfg, seed=0)
    gru_cell.launches = 0
    encoder_forward.launches = 0
    run_policy(policy, cfg, card)
    launches = {"gru_cell": gru_cell.launches, "encoder": encoder_forward.launches}
    profile_policy(policy, cfg, card)
    for k in kernels:
        k["launches"] = launches[k["name"]]
        if k["launches"] == 0:
            fail(f"the policy path never launched {k['name']}")

    # Times at N = 64; the N = 1 times are on the "kernels:" lines above.
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
