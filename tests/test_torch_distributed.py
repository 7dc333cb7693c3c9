"""Two processes of the port over ``torch.distributed`` (gloo, the CPU):
the port of ``tests/test_distributed.py``.  Each process is one rank of
``runtime.mesh_shape=[2,1]`` with its own env farm and ring shard: it runs
this file as a script (``rank_main``): ``configs/fake_smoke.yaml`` for 2
iterations (4 envs on the host: 2 a rank), a checkpoint, then a resume into
a third iteration from a fresh ``Dreamer``, and prints ``CHECKSUM <value>``
of its parameters.  The ``model_axis`` case runs ``runtime.mesh_shape=[1,2]``
instead: both ranks hold all 4 envs' ring, rank 0 steps them and broadcasts
each round, and each keeps the moments of its half of the sharded weights
(the GRU 64 wide shards nothing at fake_smoke's widths, so the case widens
the GRU and the latents).  The two ranks' checksums must agree (the learner stays
in lockstep); only rank 0 writes ``metrics.csv``; ``LATEST`` names the last
checkpoint and every rank wrote its shard of it.  Once with synchronous
checkpoints, once with ``runtime.async_checkpoint``.  Marked slow (two
processes and a short schedule each)."""

import csv
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMOKE = os.path.join(REPO, "configs", "fake_smoke.yaml")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.slow
@pytest.mark.parametrize("extra", [[], ["runtime.async_checkpoint=true"],
                                   ["runtime.mesh_shape=[1,2]", "wm.hidden_dim=128",
                                    "wm.latent_rows=16", "wm.latent_classes=16"]],
                         ids=["sync", "async_checkpoint", "model_axis"])
def test_two_process_train_and_resume(tmp_path, extra):
    port = _free_port()
    procs = []
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   DREAMER_DIST_TIMEOUT_S="120")
        procs.append(subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                       str(tmp_path), *extra],
                                      env=env, cwd=REPO, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out[-4000:]}"

    sums = [line.split()[1] for out in outs for line in out.splitlines()
            if line.startswith("CHECKSUM ")]
    assert len(sums) == 2 and sums[0] == sums[1], f"post-resume parameters differ: {sums}"
    # Rank 0 alone prints progress.
    assert "Starting Training..." in outs[0] and "Starting Training..." not in outs[1]

    logs, models = tmp_path / "logs", tmp_path / "models"
    with open(logs / "metrics.csv") as f:
        iters = [int(r["iteration"]) for r in csv.DictReader(f) if r.get("wm/loss")]
    assert iters == [3]   # the resumed leg; the first run's rows are metrics.leg1.csv
    with open(logs / "metrics.leg1.csv") as f:
        assert [int(r["iteration"]) for r in csv.DictReader(f) if r.get("wm/loss")] == [1, 2]
    assert (models / "LATEST").read_text() == "3"
    assert {"ckpt_3", "ckpt_3.rank0", "ckpt_3.rank1"} <= set(os.listdir(models))


def rank_main(out_dir: str, extra) -> None:
    """One rank, under torchrun's variables (the parent sets them)."""
    import torch

    from dreamer_tpu_torch.config import DreamerConfig
    from dreamer_tpu_torch.orchestrator import Dreamer
    from dreamer_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    assert distributed.init_distributed(device="cpu"), "expected two ranks"
    rank = distributed.rank()

    def make_cfg(iters: int) -> DreamerConfig:
        return DreamerConfig.from_yaml(SMOKE, overrides=[
            "runtime.mesh_shape=[2,1]", "runtime.rollout_device=cpu",
            "env.num_envs=4", "train.batch_size=8", "train.sequence_length=16",
            f"train.training_iterations={iters}", "train.random_iterations=1",
            "train.eval_every=2", "train.eval_episodes=2", "train.final_eval_episodes=2",
            "train.checkpoint_every=2", f"runtime.log_dir={out_dir}/logs",
            f"runtime.checkpoint_dir={out_dir}/models", *extra])

    try:
        d = Dreamer(make_cfg(2), device="cpu")
        n_data, n_model = d.plan.mesh_shape
        envs = 4 // n_data
        assert d.trainer.cfg.env.num_envs == 4 and d.buf.obs.shape[0] == envs
        if rank % n_model == 0:
            assert d.farm.num_envs == envs
        else:   # its model group's first rank steps the envs
            assert d.farm is None
        if n_model > 1:   # the moments of the sharded weights are a rank's half
            blocks = [b for b in d.state.wm.opt.blocks if b is not None]
            assert blocks and all(b.index == rank for b in blocks)
        assert d.metrics.enabled == (rank == 0)
        d.train(progress=distributed.is_primary())
        d.close()
        assert d.iteration == 2
        d2 = Dreamer(make_cfg(3), device="cpu", resuming=True)
        d2.train(resume=True, progress=distributed.is_primary())
        d2.close()
        assert d2.iteration == 3, d2.iteration
        # The data index's own env seeds.
        assert d2._rank_offset == (rank // n_model) * 100_003
        params = [*d2.state.wm.nets.parameters(), *d2.state.ac.actor.parameters(),
                  *d2.state.ac.critic.parameters()]
        total = sum(float(p.detach().double().abs().sum()) for p in params)
        print(f"CHECKSUM {total:.10e}", flush=True)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    rank_main(sys.argv[1], sys.argv[2:])
