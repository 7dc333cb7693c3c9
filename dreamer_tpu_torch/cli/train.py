"""Train a DreamerV3 agent with the port (``dreamer_tpu/cli/train.py``):

    python -m dreamer_tpu_torch.cli.train --config configs/car_racer.yaml \
        --env-maker gymnasium:make \
        [--overrides train.training_iterations=100 ...] [--resume] [--device cpu]

On several ranks (``runtime.mesh_shape = [n, m]``, n x m ranks), through
torchrun:

    torchrun --nproc_per_node 2 -m dreamer_tpu_torch.cli.train --config ... \
        --device cpu                      # two ranks on the CPU over gloo
    torchrun --nproc_per_node 2 -m dreamer_tpu_torch.cli.train --config ...
                                          # one card a rank, cuda:{LOCAL_RANK}, nccl
    torchrun --nproc_per_node 2 -m dreamer_tpu_torch.cli.train --config ... \
        --device cuda:0 --dist-backend gloo   # two ranks sharing one card
    torchrun --nproc_per_node 4 -m dreamer_tpu_torch.cli.train --config ... \
        --overrides runtime.mesh_shape=[2,2] ...   # a model axis of 2

The default mesh is ``[world_size, 1]``, the data axis alone.  A model axis
m > 1 (``--overrides runtime.mesh_shape=[n,m]``, n x m the world size)
gives the update of one process with n data shards, as JAX's column-sharded
weights do: each rank of a model group of m keeps AdamW's moments of its
block of the big kernels' columns, updates that block and gathers the
others (``parallel.sharding``); the group's first rank steps its envs.

Reads the nested YAML schema and the reference's flat one.  Runs on the card
unless ``--device`` names another device, and fails without one.  Every
``env.env_id`` but ``fake`` needs ``--env-maker MODULE:FUNCTION``, a
function with ``gymnasium.make``'s signature that builds the base env under
the wrapper stack (``gymnasium:make`` on a machine with gymnasium and
Box2D); it has no default, so the port names no gymnasium module.  Honours
SM_MODEL_DIR (checkpoints) and SM_OUTPUT_DATA_DIR (logs).  SIGTERM
checkpoints after the current iteration and exits 75 (EX_TEMPFAIL), once the
checkpoint is on disk, so a supervisor resumes the run instead of reading it
as finished.  ``runtime.debug_nans`` stops the run at the first non-finite
value of an update or a policy step with ``FloatingPointError``.

Under torchrun the process group is joined before anything touches CUDA
(``parallel.init_distributed``; ``--dist-backend`` defaults to nccl on a
CUDA device, gloo on the CPU), ``runtime.mesh_shape`` defaults to
``[world_size, 1]``, the multi-rank run needs ``runtime.rollout_device=cpu``
(the host-local actor), and only rank 0 prints and logs.
"""

from __future__ import annotations

import argparse
import os
import signal

import torch

from dreamer_tpu_torch.config import DreamerConfig
from dreamer_tpu_torch.envs import missing_maker_message
from dreamer_tpu_torch.orchestrator import Dreamer
from dreamer_tpu_torch.parallel import distributed
from dreamer_tpu_torch.train.step import resolve_device


def main(argv=None) -> float:
    parser = argparse.ArgumentParser(description="Train a dreamer_tpu_torch agent")
    parser.add_argument("--config", type=str, required=True,
                        help="Path to YAML config (nested or reference flat schema)")
    parser.add_argument("--overrides", type=str, nargs="*", default=[],
                        help="Dotted config overrides, e.g. train.batch_size=16")
    parser.add_argument("--resume", action="store_true",
                        help="Resume from the latest checkpoint if present")
    parser.add_argument("--device", type=str, default=None,
                        help="A torch device (e.g. 'cpu'); default the CUDA card")
    parser.add_argument("--env-maker", type=str, default=None, metavar="MODULE:FUNCTION",
                        help="Builds the base env under the wrapper stack, with "
                             "gymnasium.make's signature (e.g. gymnasium:make); needed by "
                             "every env.env_id but 'fake'")
    parser.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                        help="The process group's backend under torchrun; default nccl on a "
                             "CUDA device, gloo on the CPU (ranks sharing a card name gloo)")
    args = parser.parse_args(argv)
    # Before anything touches CUDA; a no-op for one process.
    multiprocess = distributed.init_distributed(args.dist_backend, args.device)
    primary = distributed.is_primary()

    cfg = DreamerConfig.from_yaml(args.config, overrides=args.overrides)
    if cfg.env.env_id != "fake" and args.env_maker is None:
        command = " ".join(["python -m dreamer_tpu_torch.cli.train", "--config", args.config,
                            "--env-maker gymnasium:make"]
                           + (["--overrides", *args.overrides] if args.overrides else [])
                           + (["--resume"] if args.resume else [])
                           + (["--device", args.device] if args.device else []))
        parser.error(f"{missing_maker_message(cfg.env.env_id)}, e.g.\n  {command}")
    model_dir = os.environ.get("SM_MODEL_DIR")
    output_dir = os.environ.get("SM_OUTPUT_DATA_DIR")
    if model_dir:
        cfg = cfg.with_override(f"runtime.checkpoint_dir={model_dir}")
    if output_dir:
        cfg = cfg.with_override(f"runtime.log_dir={output_dir}")

    if multiprocess and not cfg.runtime.mesh_shape:
        cfg = cfg.with_override(f"runtime.mesh_shape=[{distributed.world_size()}, 1]")

    device = resolve_device(distributed.rank_device(args.device))
    if primary:
        print(f"device: {torch.cuda.get_device_name(device) if device.type == 'cuda' else device}",
              flush=True)
        if multiprocess:
            n, m = cfg.runtime.mesh_shape
            print(f"mesh [{n}, {m}] (data, model): {distributed.world_size()} ranks on "
                  f"{distributed.hosts()} host(s), {torch.distributed.get_backend()}",
                  flush=True)
    if cfg.runtime.debug_nans and primary:
        # The port of jax_debug_nans: the first non-finite value of an update
        # or a policy step raises FloatingPointError naming it.
        print("debug_nans: every update and policy step stops at its first non-finite value",
              flush=True)
    dreamer = Dreamer(cfg, env_maker=args.env_maker, resuming=args.resume, device=device)
    previous = signal.signal(signal.SIGTERM, lambda *_: dreamer.request_stop())
    try:
        final_reward = dreamer.train(resume=args.resume, progress=primary)
        if dreamer.stopped:
            if primary:
                print(f"Preempted at iter {dreamer.iteration} (checkpointed).", flush=True)
            raise SystemExit(75)
        if primary:
            print(f"Final eval reward: {final_reward:.2f}", flush=True)
        dreamer.metrics.save_npz()
        return final_reward
    finally:
        signal.signal(signal.SIGTERM, previous)
        dreamer.close()


if __name__ == "__main__":
    try:
        main()
    finally:
        distributed.shutdown()
