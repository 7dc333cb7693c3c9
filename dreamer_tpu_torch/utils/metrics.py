"""Metrics logging (a copy of ``dreamer_tpu/utils/metrics.py``): per-iteration
metrics accumulated on the host, a CSV stream and a reference-compatible
.npz dump.

The .npz keys (world_model_loss, actor_loss, critic_loss, rewards) match the
reference's training_logs.npz (Dreamer.py:356-364, train_car_racer.py:47-53)
so its Results_Graphing notebook loads our logs unchanged.
"""

from __future__ import annotations

import csv
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np


class MetricsLogger:
    def __init__(self, log_dir: str, csv_name: str = "metrics.csv", resuming: bool = True):
        """``resuming`` controls what happens to pre-existing metrics files in
        the log_dir: ``True`` (a supervised restart / --resume) rotates them
        to ``.legN`` names that ``tools/harvest_evidence.py`` concatenates
        back into one curve; ``False`` (a fresh run reusing a log_dir)
        archives them to ``.staleN`` names that harvest IGNORES — otherwise
        an unrelated previous run's legs would pollute the new run's curves
        and wall-time stats."""
        self.log_dir = os.path.abspath(log_dir)
        os.makedirs(self.log_dir, exist_ok=True)
        self.wm_losses: List[List[float]] = []   # per-iter list of per-epoch losses
        self.actor_losses: List[float] = []
        self.critic_losses: List[float] = []
        self.eval_rewards: List[float] = []
        self._csv_path = os.path.join(self.log_dir, csv_name)
        # A supervised run restarts into the SAME log_dir; opening the
        # csv/npz with "w" would destroy the previous legs' metrics.
        # Rotate existing files to leg-numbered (resume) or
        # stale-numbered (fresh start) names.
        tag = "leg" if resuming else "stale"
        self._rotate_existing(self._csv_path, tag)
        self._rotate_existing(os.path.join(self.log_dir, "training_logs.npz"), tag)
        self._csv_file = None
        self._csv_writer = None
        self._csv_fields: Optional[List[str]] = None
        self._t0 = time.time()

    @staticmethod
    def _rotate_existing(path: str, tag: str = "leg"):
        if not os.path.exists(path):
            return
        base, ext = os.path.splitext(path)
        n = 1
        while os.path.exists(f"{base}.{tag}{n}{ext}"):
            n += 1
        os.replace(path, f"{base}.{tag}{n}{ext}")

    # ------------------------------------------------------------------ #

    def log_iteration(self, iteration: int, metrics: Dict[str, Any]):
        """Record one training iteration's scalar metrics dict."""
        row = {"iteration": iteration, "wall_time": time.time() - self._t0}
        # Scalars land in the CSV; small vectors (per-epoch losses) are
        # accumulated for the npz but kept out of the CSV row.
        vectors: Dict[str, np.ndarray] = {}
        for k, v in metrics.items():
            arr = np.asarray(v)
            if arr.ndim == 0:
                row[k] = float(arr)
            else:
                vectors[k] = arr
        if "wm/loss_epochs" in vectors:
            # One entry per WM epoch, like the reference's flat loss list
            # (Dreamer.py:240 appends inside the epoch loop).
            self.wm_losses.append([float(x) for x in vectors["wm/loss_epochs"].ravel()])
        elif "wm/loss" in row:
            self.wm_losses.append([row["wm/loss"]])
        if "ac/loss_actor" in row:
            self.actor_losses.append(row["ac/loss_actor"])
        if "ac/loss_critic" in row:
            self.critic_losses.append(row["ac/loss_critic"])
        self._write_csv(row)

    def log_eval(self, iteration: int, mean_reward: float):
        self.eval_rewards.append(float(mean_reward))
        self._write_csv({"iteration": iteration, "eval/mean_reward": float(mean_reward),
                         "wall_time": time.time() - self._t0})

    def _write_csv(self, row: Dict[str, Any]):
        if self._csv_writer is None:
            self._csv_fields = sorted(row.keys())
            self._csv_file = open(self._csv_path, "w", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=self._csv_fields,
                                              extrasaction="ignore", restval="")
            self._csv_writer.writeheader()
        extra = [k for k in row if k not in self._csv_fields]
        if extra:
            # Re-open with the union of fields (rare: first eval row).
            self._csv_fields = sorted(set(self._csv_fields) | set(row.keys()))
            self._csv_file.close()
            with open(self._csv_path, newline="") as f:
                old = list(csv.DictReader(f))
            self._csv_file = open(self._csv_path, "w", newline="")
            self._csv_writer = csv.DictWriter(self._csv_file, fieldnames=self._csv_fields,
                                              extrasaction="ignore", restval="")
            self._csv_writer.writeheader()
            for r in old:
                self._csv_writer.writerow(r)
        self._csv_writer.writerow(row)
        self._csv_file.flush()

    # ------------------------------------------------------------------ #

    def save_npz(self, path: Optional[str] = None):
        """Reference-compatible dump (same keys as training_logs.npz)."""
        path = path or os.path.join(self.log_dir, "training_logs.npz")
        wm = (np.concatenate([np.asarray(r, np.float32) for r in self.wm_losses])
              if self.wm_losses else np.zeros((0,), np.float32))
        np.savez(
            path,
            world_model_loss=wm,
            actor_loss=np.asarray(self.actor_losses, dtype=np.float32),
            critic_loss=np.asarray(self.critic_losses, dtype=np.float32),
            rewards=np.asarray(self.eval_rewards, dtype=np.float32),
        )
        return path

    def close(self):
        if self._csv_file is not None:
            self._csv_file.close()
