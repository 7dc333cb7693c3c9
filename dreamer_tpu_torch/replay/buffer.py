"""Device-resident circular replay buffer over an env axis
(``dreamer_tpu/replay/buffer.py:57-272``).

Layout ``(num_envs, capacity_per_env, ...)``: each env writes its own
temporally contiguous ring, all from one shared write head (the envs step in
lockstep).  Frames are stored uint8 on the device, rewards symlog'd at
write, continues and the optional episode-start channel as float {0, 1}.
Sampling draws a uniform (env, start) per batch row over [0, size - T + 1),
re-rolls once a window that strictly contains the write head of a full ring,
and gathers the windows on the device.

The write head and fill level are host integers: the host drives every
write, so it knows them without a device sync.  The three integer draws of a
sample come from the caller's ``torch.Generator``; ``pick_indices`` takes them
as arguments, so tests can inject JAX's.

Shards (the data axis, JAX's ``_draw_indices(..., n_shards)`` and
``sample_shard_local``, ``buffer.py:166-200, 232-272``): with ``n_shards``
S, row b of a batch belongs to shard b // (B/S), which owns env block s, and
draws its env within that block; ``n_shards=1`` draws exactly the unsharded
stream.  A shard's ring (``init_state(n_shards=S)``) holds only its env
block; ``sample(..., shard=s)`` draws the whole batch's indices, as every
shard does, then keeps its own rows and rebases their envs into its block.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from dreamer_tpu_torch.core.math import symlog

Tensor = torch.Tensor


@dataclass
class ReplayState:
    obs: Tensor                     # (E, C, H, W, 3) uint8
    action: Tensor                  # (E, C, A) float32
    reward: Tensor                  # (E, C) float32, symlog applied at write
    cont: Tensor                    # (E, C) float32
    next_idx: int = 0               # shared write head
    size: int = 0                   # filled slots per env
    first: Optional[Tensor] = None  # (E, C) float32, or None


class ReplayBuffer:
    """``capacity`` is the total transition budget; each of ``num_envs``
    streams gets ``capacity // num_envs`` slots."""

    def __init__(self, capacity: int, sequence_length: int, action_dim: int,
                 obs_size: Tuple[int, int], num_envs: int = 1, store_firsts: bool = False):
        if capacity % num_envs:
            raise ValueError("capacity must divide by num_envs")
        self.num_envs = num_envs
        self.capacity = capacity // num_envs
        self.sequence_length = sequence_length
        self.action_dim = action_dim
        self.obs_size = obs_size
        self.store_firsts = store_firsts

    def init_state(self, device=None, n_shards: int = 1) -> ReplayState:
        """An empty ring of all envs, or of one shard's env block."""
        if self.num_envs % n_shards:
            raise ValueError(f"{self.num_envs} envs do not divide into {n_shards} shards")
        e, c = self.num_envs // n_shards, self.capacity
        f32 = dict(dtype=torch.float32, device=device)
        return ReplayState(
            obs=torch.zeros((e, c, *self.obs_size, 3), dtype=torch.uint8, device=device),
            action=torch.zeros((e, c, self.action_dim), **f32),
            reward=torch.zeros((e, c), **f32), cont=torch.zeros((e, c), **f32),
            first=torch.zeros((e, c), **f32) if self.store_firsts else None)

    def add_batch(self, state: ReplayState, obs: Tensor, action: Tensor, reward: Tensor,
                  cont: Tensor, first: Optional[Tensor] = None) -> ReplayState:
        """Append n lockstep transitions per env: obs (E, n, H, W, 3) uint8,
        action (E, n, A), raw reward and cont (E, n), first (E, n) iff the
        buffer stores it.  Writes wrap around the ring; where n exceeds the
        capacity the last write of a slot wins.  The ring is written in place;
        the returned state carries the new head and size."""
        if (first is not None) != self.store_firsts:
            raise ValueError("add_batch: first must be given iff the buffer stores it")
        n = obs.shape[1]
        pos = (state.next_idx + torch.arange(n, device=state.obs.device)) % self.capacity
        keep = slice(max(0, n - self.capacity), n)  # the writes that survive
        pos = pos[keep]
        state.obs[:, pos] = obs[:, keep].to(torch.uint8)
        state.action[:, pos] = action[:, keep].float()
        state.reward[:, pos] = symlog(reward[:, keep].float())
        state.cont[:, pos] = cont[:, keep].float()
        if first is not None:
            state.first[:, pos] = first[:, keep].float()
        state.next_idx = (state.next_idx + n) % self.capacity
        state.size = min(state.size + n, self.capacity)
        return state

    def valid_starts(self, state: ReplayState) -> int:
        return max(state.size - self.sequence_length + 1, 1)

    def pick_indices(self, state: ReplayState, env_idx: Tensor, starts: Tensor,
                     reroll: Tensor) -> Tuple[Tensor, Tensor]:
        """The (env, start) of each row from the three uniform draws: a start
        whose window strictly contains the write head of a full ring is
        replaced by its re-roll (``buffer.py:166-200``)."""
        T = self.sequence_length
        full = state.size == self.capacity
        collide = (starts < state.next_idx) & (state.next_idx < starts + T)
        return env_idx, torch.where(collide & full, reroll, starts)

    def draw_indices(self, state: ReplayState, batch_size: int, generator: torch.Generator,
                     n_shards: int = 1) -> Tuple[Tensor, Tensor]:
        """The (env, start) of every row of a global batch: with ``n_shards``
        S, row b draws its env within the block of shard b // (B/S)."""
        dev = state.obs.device
        hi = self.valid_starts(state)
        if n_shards > 1:
            if batch_size % n_shards or self.num_envs % n_shards:
                raise ValueError(f"batch {batch_size} and {self.num_envs} envs must divide "
                                 f"into {n_shards} shards")
            e_local = self.num_envs // n_shards
            shard_of_row = torch.arange(batch_size, device=dev) // (batch_size // n_shards)
            env_idx = shard_of_row * e_local + torch.randint(
                0, e_local, (batch_size,), generator=generator, device=dev)
        else:
            env_idx = torch.randint(0, self.num_envs, (batch_size,), generator=generator,
                                    device=dev)
        starts = torch.randint(0, hi, (batch_size,), generator=generator, device=dev)
        reroll = torch.randint(0, hi, (batch_size,), generator=generator, device=dev)
        return self.pick_indices(state, env_idx, starts, reroll)

    def gather(self, state: ReplayState, env_idx: Tensor, starts: Tensor,
               t_out: Optional[int] = None, with_scalars: bool = True):
        """The windows [start, start + t_out) of the rows (t_out defaults to
        the sequence length): (obs_u8, action[, reward, cont[, first]])."""
        T = self.sequence_length
        if t_out is not None and not 0 < t_out <= T:
            raise ValueError(f"t_out={t_out} must lie in (0, sequence_length={T}]")
        Tg = T if t_out is None else t_out
        idx = (starts[:, None] + torch.arange(Tg, device=starts.device)[None, :]) \
            % self.capacity
        e = env_idx[:, None]
        out = (state.obs[e, idx], state.action[e, idx])
        if not with_scalars:
            return out
        out = out + (state.reward[e, idx], state.cont[e, idx])
        if state.first is not None:
            out = out + (state.first[e, idx],)
        return out

    def sample(self, state: ReplayState, batch_size: int, generator: torch.Generator,
               t_out: Optional[int] = None, with_scalars: bool = True, n_shards: int = 1,
               shard: Optional[int] = None):
        """A batch of ``batch_size`` windows (see ``gather``).  With ``shard``
        s, ``state`` is shard s's ring and the batch is its block of rows."""
        env_idx, starts = self.draw_indices(state, batch_size, generator, n_shards)
        if shard is not None:
            per, e_local = batch_size // n_shards, self.num_envs // n_shards
            rows = slice(shard * per, (shard + 1) * per)
            env_idx, starts = env_idx[rows] - shard * e_local, starts[rows]
        return self.gather(state, env_idx, starts, t_out, with_scalars)
