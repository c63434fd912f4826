from ape_x_dqn_tpu_torch.envs.base import Env, EnvSpec, make_env
from ape_x_dqn_tpu_torch.envs.vector import SyncVectorEnv

__all__ = ["Env", "EnvSpec", "SyncVectorEnv", "make_env"]
