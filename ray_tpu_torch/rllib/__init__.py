"""ray_tpu_torch.rllib — reinforcement learning, the learners on the card.

Counterpart of ``ray_tpu/rllib`` (reference surface: ``Algorithm``,
``LearnerGroup``, ``EnvRunner``).  The reference compiles each update into
one jitted program, data-parallel over a device mesh; the port runs the
same update eagerly on the card (``device=None``) or the CPU
(``device="cpu"``), and ``LearnerGroup(num_learners=N)`` splits PPO's batch
over a device list from one process.  Runners (gymnasium stepping, the
policy on the runner's device) are held in-process until the port reaches
the runtime (ROADMAP A4); gymnasium is imported only by the runners and
drivers, so this package imports without it.

Ported: PPO and A2C (MLP and the Nature CNN), DQN, Rainbow, SAC, TD3 and
DDPG.  Not yet (ROADMAP A8's second part): BC / MARWIL / CQL, IMPALA /
APPO, multi-agent, the external-env protocol, ES / ARS, APEX and the
learner actors.
"""

from .a2c import A2C, A2CConfig
from .conv import NATURE_FILTERS, ActorCriticConv
from .ddpg import DDPG, DDPGConfig
from .dqn import DQN, DQNConfig, DQNRunner, QNetwork, build_q_model
from .env_runner import EnvRunner
from .learner import Learner, LearnerGroup
from .models import ActorCriticMLP, build_model
from .ppo import PPO, PPOConfig
from .rainbow import DistQNetwork, Rainbow, RainbowConfig
from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from .sac import QNetworkSA, SAC, SACConfig, SACRunner, SquashedGaussianPolicy
from .td3 import TD3, TD3Config, TD3Runner, DeterministicPolicy

__all__ = ["PPO", "PPOConfig", "A2C", "A2CConfig", "DQN", "DQNConfig",
           "SAC", "SACConfig", "DDPG", "DDPGConfig", "TD3", "TD3Config",
           "Rainbow", "RainbowConfig", "DistQNetwork",
           "QNetwork", "EnvRunner", "Learner", "LearnerGroup",
           "ActorCriticMLP", "ActorCriticConv", "build_model",
           "ReplayBuffer", "PrioritizedReplayBuffer",
           "NATURE_FILTERS", "DQNRunner", "build_q_model", "QNetworkSA",
           "SACRunner", "SquashedGaussianPolicy", "TD3Runner",
           "DeterministicPolicy"]
