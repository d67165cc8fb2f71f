from .envs import EnvSpec, Pendulum, PointGoal
from .pmdb import DynamicsEnsemble, pessimistic_rollout
from .rllg import GuidedSAC
from .sac import SAC, ReplayBuffer, SACState
from .simmer import SauteWrapper, SimmerController
from .convert import dynamics_from_jax, sac_from_flax
