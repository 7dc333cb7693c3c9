from dreamer_tpu_torch.nets.actor_critic import Actor, Critic
from dreamer_tpu_torch.nets.gru import GRUCell
from dreamer_tpu_torch.nets.mlp import MLP
from dreamer_tpu_torch.nets.wm_nets import WMNets

__all__ = ["MLP", "GRUCell", "WMNets", "Actor", "Critic"]
