"""Atari environment stack.

Counterpart of ``ape_x_dqn_tpu/envs/atari.py``, in two halves:

1. A **raw** ALE-like interface (`RawAtariEnv`): 210x160x3 uint8 frames,
   minimal discrete action set, `lives`. Backed by the real Arcade
   Learning Environment when `ale_py` is importable, else by
   `SyntheticAtari` — a native, deterministic catch-style game that
   exercises every preprocessing stage (sprite flicker for max-pooling,
   lives for episodic-life, dense +/-1 rewards for clipping).

2. `AtariPreprocessing`: the canonical DQN pipeline — noop starts,
   frame-skip 4 with max-pool over the last two raw frames, grayscale,
   84x84 bilinear resize, episodic life, reward clipping, frame-stack 4 —
   producing (84, 84, 4) uint8 observations.

The frame preprocessing runs the fused C++ host kernel
(``cpp/preproc.cpp`` through envs/native.py) when g++ can build it, and
the numpy path otherwise; the two are bit-identical.
"""

from __future__ import annotations

import numpy as np

from ape_x_dqn_tpu_torch.envs import native
from ape_x_dqn_tpu_torch.envs.base import Env, EnvSpec

try:  # real ALE if the user's environment has it
    import ale_py  # type: ignore  # noqa: F401
    HAVE_ALE = True
except ImportError:
    HAVE_ALE = False


# ---------------------------------------------------------------------------
# Raw layer


class RawAtariEnv:
    """ALE-compatible raw interface: 210x160x3 uint8 frames."""

    height = 210
    width = 160
    num_actions: int

    def reset(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, action: int) -> tuple[np.ndarray, float, bool]:
        raise NotImplementedError

    @property
    def lives(self) -> int:
        raise NotImplementedError

    def seed(self, seed: int) -> None:
        pass


class SyntheticAtari(RawAtariEnv):
    """Native catch-style game with ALE-shaped output.

    A ball falls from the top of a 210x160 screen; a paddle near the
    bottom moves with Pong's minimal action set (NOOP FIRE RIGHT LEFT
    RIGHTFIRE LEFTFIRE). Catch = +1, miss = -1 and loses one of 5 lives.
    The ball sprite is drawn only on even raw frames (ALE-style sprite
    flicker), so skipping without max-pooling loses the ball half the
    time — a behavioral test of the preprocessing stack.
    """

    num_actions = 6
    BALL = 8  # ball edge px
    PADDLE_W = 24
    PADDLE_H = 6
    PADDLE_Y = 190
    BALL_SPEED = 2
    PADDLE_SPEED = 4
    LIVES = 5

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._frame_count = 0
        self._lives = self.LIVES
        self._done = True
        self._ball_x = 0
        self._ball_y = 0
        self._paddle_x = 0

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)

    @property
    def lives(self) -> int:
        return self._lives

    def _spawn_ball(self) -> None:
        self._ball_x = int(self._rng.integers(0, self.width - self.BALL))
        self._ball_y = 0

    def reset(self) -> np.ndarray:
        self._lives = self.LIVES
        self._done = False
        self._frame_count = 0
        self._paddle_x = (self.width - self.PADDLE_W) // 2
        self._spawn_ball()
        return self._render()

    def step(self, action: int):
        if self._done:
            raise RuntimeError("step() on done env; call reset()")
        if not 0 <= action < self.num_actions:
            raise ValueError(f"action {action} outside [0, {self.num_actions})")
        if action in (2, 4):  # RIGHT / RIGHTFIRE
            self._paddle_x += self.PADDLE_SPEED
        elif action in (3, 5):  # LEFT / LEFTFIRE
            self._paddle_x -= self.PADDLE_SPEED
        self._paddle_x = int(
            np.clip(self._paddle_x, 0, self.width - self.PADDLE_W))

        self._ball_y += self.BALL_SPEED
        self._frame_count += 1
        reward = 0.0
        if self._ball_y + self.BALL >= self.PADDLE_Y:
            caught = (self._ball_x + self.BALL > self._paddle_x
                      and self._ball_x < self._paddle_x + self.PADDLE_W)
            if caught:
                reward = 1.0
            else:
                reward = -1.0
                self._lives -= 1
                if self._lives == 0:
                    self._done = True
            self._spawn_ball()
        return self._render(), reward, self._done

    def _render(self) -> np.ndarray:
        frame = np.zeros((self.height, self.width, 3), np.uint8)
        frame[..., 2] = 40  # dark blue background
        # paddle: always drawn
        frame[self.PADDLE_Y:self.PADDLE_Y + self.PADDLE_H,
              self._paddle_x:self._paddle_x + self.PADDLE_W] = (200, 72, 72)
        # ball: flickers (drawn on even frames only)
        if self._frame_count % 2 == 0:
            y, x = self._ball_y, self._ball_x
            frame[y:y + self.BALL, x:x + self.BALL] = (236, 236, 236)
        return frame


class ALERawEnv(RawAtariEnv):
    """Real Arcade Learning Environment behind the raw interface.

    full_action_set: use ALE's 18-action legal set instead of the
    per-game minimal set. Required when one Q-net serves MANY games
    (the atari57 fleet): minimal sets differ per game (4 for breakout,
    18 for alien), so a shared net sized off one game's probe env would
    emit out-of-range action indices on the others; the legal set is
    valid everywhere (redundant actions just alias NOOP/directions)."""

    def __init__(self, game: str, seed: int = 0, repeat_action_prob=0.25,
                 full_action_set: bool = False):
        from ale_py import ALEInterface, roms  # type: ignore
        self._ale = ALEInterface()
        self._ale.setInt("random_seed", seed)
        self._ale.setFloat("repeat_action_probability", repeat_action_prob)
        self._ale.loadROM(roms.get_rom_path(game))
        self._actions = (self._ale.getLegalActionSet() if full_action_set
                         else self._ale.getMinimalActionSet())
        self.num_actions = len(self._actions)

    def reset(self) -> np.ndarray:
        self._ale.reset_game()
        return self._ale.getScreenRGB()

    def step(self, action: int):
        reward = self._ale.act(self._actions[action])
        return (self._ale.getScreenRGB(), float(reward),
                self._ale.game_over())

    @property
    def lives(self) -> int:
        return self._ale.lives()


# ---------------------------------------------------------------------------
# Preprocessing


_RESIZE_CACHE: dict = {}


def bilinear_resize(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Bilinear resize of a (H, W) array with cached index/weight tables."""
    h, w = img.shape
    key = (h, w, out_h, out_w)
    tables = _RESIZE_CACHE.get(key)
    if tables is None:
        # align_corners=False convention (matches cv2.INTER_LINEAR)
        ys = (np.arange(out_h) + 0.5) * h / out_h - 0.5
        xs = (np.arange(out_w) + 0.5) * w / out_w - 0.5
        y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
        y1 = np.minimum(y0 + 1, h - 1)
        x1 = np.minimum(x0 + 1, w - 1)
        wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)
        wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)
        tables = (y0, y1, wy[:, None], x0, x1, wx[None, :])
        _RESIZE_CACHE[key] = tables
    y0, y1, wy, x0, x1, wx = tables
    img = img.astype(np.float32)
    r0, r1 = img[y0], img[y1]
    top = r0[:, x0] * (1 - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (1 - wx) + r1[:, x1] * wx
    return top * (1 - wy) + bot * wy


def grayscale(frame: np.ndarray) -> np.ndarray:
    return (0.299 * frame[..., 0] + 0.587 * frame[..., 1]
            + 0.114 * frame[..., 2])


class AtariPreprocessing(Env):
    """The canonical DQN preprocessing pipeline over a RawAtariEnv."""

    def __init__(self, raw: RawAtariEnv, frame_skip=4, frame_stack=4,
                 resize=84, max_noop_start=30, episodic_life=True,
                 clip_rewards=True, max_episode_frames=108_000, seed=0):
        self._raw = raw
        self._frame_skip = frame_skip
        self._stack = frame_stack
        self._size = resize
        self._max_noop = max_noop_start
        self._episodic_life = episodic_life
        self._clip = clip_rewards
        self._max_frames = max_episode_frames
        self._rng = np.random.default_rng(seed)
        self._frames = np.zeros((resize, resize, frame_stack), np.uint8)
        self._raw_done = True
        self._truncated = False
        self._lives = 0
        self._elapsed = 0
        self._ep_return = 0.0  # unclipped, for eval/HNS
        self.spec = EnvSpec(obs_shape=(resize, resize, frame_stack),
                            obs_dtype=np.dtype(np.uint8), discrete=True,
                            num_actions=raw.num_actions)

    def seed(self, seed: int) -> None:
        self._rng = np.random.default_rng(seed)
        self._raw.seed(seed)

    def _observe(self, f0: np.ndarray,
                 f1: np.ndarray | None = None) -> np.ndarray:
        """max(f0, f1) -> gray -> resize -> stack shift. The fused C++
        kernel (cpp/preproc.cpp via envs/native.py) and the numpy path
        are bit-identical; the native one skips the per-frame float
        intermediates that dominate an actor's env-step cost."""
        small = native.preproc(f0, f1, self._size, self._size)
        if small is None:
            fm = f0 if f1 is None else np.maximum(f0, f1)
            g = grayscale(fm)
            small = np.clip(bilinear_resize(g, self._size, self._size),
                            0, 255).astype(np.uint8)
        self._frames = np.concatenate(
            [self._frames[..., 1:], small[..., None]], axis=-1)
        return self._frames.copy()

    def reset(self) -> np.ndarray:
        if self._raw_done or self._truncated or not self._episodic_life:
            frame = self._full_reset()
        else:
            # episodic-life pseudo-reset: continue the same raw episode
            frame, r, done = self._raw.step(0)
            self._elapsed += 1
            self._ep_return += r  # keep eval/HNS scores exact
            if done:
                # the noop itself ended the raw episode; its return is
                # dropped (matches standard EpisodicLife wrapper behavior)
                frame = self._full_reset()
        self._lives = self._raw.lives
        return self._observe(frame)

    def _full_reset(self) -> np.ndarray:
        frame = self._raw.reset()
        self._raw_done = False
        self._truncated = False
        self._elapsed = 0
        self._ep_return = 0.0
        self._frames[:] = 0
        # noop starts: k ~ Uniform[1, max_noop] raw noop frames
        if self._max_noop > 0:
            for _ in range(int(self._rng.integers(1, self._max_noop + 1))):
                frame, _, done = self._raw.step(0)
                if done:
                    frame = self._raw.reset()
        return frame

    def step(self, action):
        total_reward = 0.0
        raw_done = False
        last2 = [None, None]
        for _ in range(self._frame_skip):
            frame, r, raw_done = self._raw.step(int(action))
            total_reward += r
            last2[0], last2[1] = last2[1], frame
            self._elapsed += 1
            if raw_done:
                break
        self._raw_done = raw_done
        self._ep_return += total_reward

        life_lost = self._raw.lives < self._lives
        self._lives = self._raw.lives
        truncated = self._elapsed >= self._max_frames
        self._truncated = truncated  # forces a full reset next reset()
        done = raw_done or truncated or (self._episodic_life and life_lost)
        terminal = raw_done or (self._episodic_life and life_lost)

        reward = float(np.sign(total_reward)) if self._clip else total_reward
        obs = self._observe(last2[1], last2[0])
        info: dict = {"terminal": terminal, "lives": self._lives,
                      "raw_reward": total_reward}
        if raw_done or truncated:
            info["episode_return"] = self._ep_return
            info["episode_length"] = self._elapsed
        return obs, reward, done, info


def atari_backend(kind: str) -> str:
    """Which raw backend `make_atari` builds for an EnvConfig kind:
    "ale" only when the real Arcade Learning Environment is importable
    AND the config asks for real Atari; otherwise "synthetic" (the catch
    stand-in). Results must carry this marker so a synthetic score can
    never masquerade as a real Atari score."""
    return "ale" if (HAVE_ALE and kind == "atari") else "synthetic"


def make_atari(cfg, seed: int = 0, actor_index: int = 0) -> Env:
    """Build the full preprocessed Atari env from an EnvConfig.

    id="atari57" is the multi-game suite id: actors spread round-robin
    across the 57 games by global actor slot."""
    game = cfg.id
    multi_game = game == "atari57"
    if multi_game:
        from ape_x_dqn_tpu_torch.utils.metrics import ATARI_HUMAN_RANDOM
        games = sorted(ATARI_HUMAN_RANDOM)
        game = games[actor_index % len(games)]
    if atari_backend(cfg.kind) == "ale":
        # multi-game fleets share one Q-net, so every game exposes the
        # same 18-action legal set (see ALERawEnv.full_action_set)
        raw: RawAtariEnv = ALERawEnv(
            _gym_id_to_ale(game), seed=seed,
            full_action_set=multi_game or getattr(
                cfg, "full_action_set", False))
    else:
        raw = SyntheticAtari(seed=seed * 9973 + actor_index)
    return AtariPreprocessing(
        raw, frame_skip=cfg.frame_skip, frame_stack=cfg.frame_stack,
        resize=cfg.resize, max_noop_start=cfg.max_noop_start,
        episodic_life=cfg.episodic_life, clip_rewards=cfg.clip_rewards,
        max_episode_frames=cfg.max_episode_frames, seed=seed)


def _gym_id_to_ale(env_id: str) -> str:
    """'PongNoFrameskip-v4' -> 'pong' (snake_case ALE rom name)."""
    name = env_id.split("NoFrameskip")[0].split("-v")[0]
    out = [name[0].lower()]
    for ch in name[1:]:
        if ch.isupper():
            out.append("_")
        out.append(ch.lower())
    return "".join(out)
