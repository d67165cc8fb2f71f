"""Meta-BO surrogates and NAP's PPO (port of ``hebo_tpu/meta``); importing
this package registers the ``nap`` model."""

from .nap import NAPSurrogate, TransformerNP, meta_train_np, nap_from_flax, sample_gp_tasks
from .ppo import NAPPolicy, policy_from_flax, ppo_train, pretrain_policy, rollout_episodes

__all__ = ["NAPSurrogate", "TransformerNP", "meta_train_np", "nap_from_flax", "sample_gp_tasks",
           "NAPPolicy", "policy_from_flax", "ppo_train", "pretrain_policy", "rollout_episodes"]
