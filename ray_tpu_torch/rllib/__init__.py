"""ray_tpu_torch.rllib — reinforcement learning, the learners on the card.

Counterpart of ``ray_tpu/rllib`` (reference surface: ``Algorithm``,
``LearnerGroup``, ``EnvRunner``).  The reference compiles each update into
one jitted program, data-parallel over a device mesh; the port runs the
same update eagerly on the card (``device=None``) or the CPU
(``device="cpu"``), and ``LearnerGroup(num_learners=N)`` splits PPO's batch
over a device list from one process.  As in the reference, the drivers
sit on the runtime (``ray_tpu_torch.init()`` first): runners, workers and
replay shards are actors (gymnasium stepping, the policy on the actor's
CPU), and ``num_learners >= 1`` runs the update in learner actors
(``DistributedLearnerGroup`` / ``LearnerWorker``: one
``torch.distributed`` group, NCCL on the cards or gloo on the CPU).
gymnasium is imported only by the runners and drivers, so this package
imports without it.

Ported: PPO and A2C (MLP and the Nature CNN), DQN, Rainbow, SAC, TD3,
DDPG, IMPALA / APPO (V-trace), BC / MARWIL / CQL (offline), ES / ARS,
Ape-X, multi-agent PPO, the external-env protocol
(``PolicyServerInput`` / ``PolicyClient`` over HTTP) and the learner
actors.
"""

from .a2c import A2C, A2CConfig
from .apex import APEX, APEXConfig, ReplayShard
from .conv import NATURE_FILTERS, ActorCriticConv
from .ddpg import DDPG, DDPGConfig
from .dqn import DQN, DQNConfig, DQNRunner, QNetwork, build_q_model
from .env_runner import EnvRunner
from .es import ARS, ARSConfig, ES, ESConfig
from .external import PolicyClient, PolicyServerInput
from .impala import APPO, APPOConfig, IMPALA, IMPALAConfig
from .learner import Learner, LearnerGroup
from .learner_group import DistributedLearnerGroup, LearnerWorker
from .models import ActorCriticMLP, build_model
from .multi_agent import (MultiAgentEnv, MultiAgentEnvRunner, MultiAgentPPO,
                          RockPaperScissors)
from .offline import (BCConfig, CQL, CQLConfig, MARWIL, MARWILConfig,
                      OfflineDataset, TransitionDataset,
                      collect_episodes, write_episodes)
from .ppo import PPO, PPOConfig
from .rainbow import DistQNetwork, Rainbow, RainbowConfig
from .replay_buffer import PrioritizedReplayBuffer, ReplayBuffer
from .sac import QNetworkSA, SAC, SACConfig, SACRunner, SquashedGaussianPolicy
from .td3 import TD3, TD3Config, TD3Runner, DeterministicPolicy

__all__ = ["PPO", "PPOConfig", "A2C", "A2CConfig", "DQN", "DQNConfig",
           "SAC", "SACConfig", "DDPG", "DDPGConfig", "TD3", "TD3Config",
           "IMPALA", "IMPALAConfig", "APPO", "APPOConfig",
           "APEX", "APEXConfig", "ReplayShard",
           "Rainbow", "RainbowConfig", "DistQNetwork",
           "ES", "ESConfig", "ARS", "ARSConfig",
           "PolicyClient", "PolicyServerInput",
           "BCConfig", "CQL", "CQLConfig", "MARWIL", "MARWILConfig",
           "OfflineDataset", "TransitionDataset",
           "collect_episodes", "write_episodes",
           "MultiAgentEnv", "MultiAgentEnvRunner", "MultiAgentPPO",
           "RockPaperScissors",
           "QNetwork", "EnvRunner", "Learner", "LearnerGroup",
           "DistributedLearnerGroup", "LearnerWorker",
           "ActorCriticMLP", "ActorCriticConv", "build_model",
           "ReplayBuffer", "PrioritizedReplayBuffer",
           "NATURE_FILTERS", "DQNRunner", "build_q_model", "QNetworkSA",
           "SACRunner", "SquashedGaussianPolicy", "TD3Runner",
           "DeterministicPolicy"]

# Usage telemetry: which libraries a cluster actually uses (reference:
# usage_lib.record_library_usage at import time).  Never raises.
from ..util.usage_stats import record_library_usage as _rlu
_rlu("rllib")
del _rlu
