from ape_x_dqn_tpu_torch.envs.base import Env, EnvSpec, make_env

__all__ = ["Env", "EnvSpec", "make_env"]
