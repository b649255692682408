"""Training pipeline pieces of the port.

Only ``build_engine`` is ported so far (``alpha_zero_tpu.training.pipeline``
holds the trainer, the resign controller and the harvest loop).
"""

from __future__ import annotations

from alpha_zero_tpu_torch.envs.go import GoEngine


def build_engine(env_cfg) -> GoEngine:
    """The engine for an EnvConfig. Go only: Gomoku is not ported yet."""
    if env_cfg.game == "go":
        return GoEngine(board_size=env_cfg.board_size, num_stack=env_cfg.num_stack,
                        komi=env_cfg.komi, max_steps=env_cfg.max_steps)
    raise ValueError(f"game {env_cfg.game!r} is not ported to alpha_zero_tpu_torch")
