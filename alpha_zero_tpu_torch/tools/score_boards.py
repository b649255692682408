"""Go boards that the scoring kernel (``ops/score_kernels.py:score_area``,
K4) is held to its plain version on, in the tests and in ``chip_smoke.py``.

- ``played_boards``: random legal games, each lane stopped at its own ply,
  so that one batch holds positions from the empty board to crowded ones.
- ``snake_boards``: boards whose empty points form long serpentine paths,
  the regions that take the plain version the most label sweeps.
- ``score_mismatches``: how many of a batch's lanes K4 (or whatever
  ``score_area`` runs on the boards' device) scores other than the plain
  version, with and without a mask.
"""

from __future__ import annotations

import numpy as np
import torch

from alpha_zero_tpu_torch.envs.types import BLACK, EMPTY, WHITE
from alpha_zero_tpu_torch.ops import score_kernels


def played_boards(engine, batch: int, plies: int, seed: int, device) -> torch.Tensor:
    """int8 ``[batch, N, N]``: lane b's board after its own number of plies
    in ``[0, plies]`` of a random legal game (uniform over the legal board
    points, a pass when there is none), all drawn from ``seed``."""
    n2 = engine.board_size ** 2
    gen = torch.Generator(device=device).manual_seed(seed)
    stop = torch.randint(0, plies + 1, (batch,), generator=gen, device=device)
    games = engine.init_batch(batch, device=device)
    boards = games.board.clone()
    for ply in range(1, plies + 1):
        legal = games.legal[:, :n2] > 0.5
        u = torch.rand(legal.shape, generator=gen, device=device)
        move = torch.where(legal, u, -1.0).argmax(dim=1).to(torch.int32)
        move = torch.where(legal.any(dim=1), move, engine.pass_move)
        games = engine.step_core(games, move)
        boards = torch.where((stop == ply)[:, None, None], games.board, boards)
    return boards


def snake_boards(n: int) -> torch.Tensor:
    """int8 ``[6, n, n]`` boards whose empty points form one serpentine path
    between walls of stones (every other row, or column, with a gap at
    alternate ends): black walls; white walls down the columns; black walls
    with one white stone (a mixed region); a wall near the middle closed,
    black walls above it and white below (a black region and a mixed one);
    and the first and third again with the path mirrored left to right."""
    snake = np.full((n, n), EMPTY, np.int8)
    for r in range(1, n, 2):
        snake[r, :] = BLACK
        snake[r, n - 1 if (r // 2) % 2 == 0 else 0] = EMPTY
    walls = snake == BLACK
    mixed = snake.copy()
    wall_points = np.argwhere(walls)
    mixed[tuple(wall_points[len(wall_points) // 2])] = WHITE
    w = (n // 2) | 1  # a wall row near the middle
    halves = snake.copy()
    halves[w] = BLACK  # its gap closed: two regions
    halves[w + 1:][walls[w + 1:]] = WHITE
    boards = [snake, np.where(walls.T, WHITE, EMPTY).astype(np.int8), mixed, halves,
              snake[:, ::-1], mixed[:, ::-1]]
    return torch.from_numpy(np.ascontiguousarray(np.stack(boards)))


def score_mismatches(engine, boards: torch.Tensor, mask: torch.Tensor) -> dict:
    """Lanes whose ``score_area`` output differs in any bit from the plain
    version's on the same device: ``unmasked`` (every lane scored) and
    ``masked`` (lanes outside ``mask`` must read 0)."""
    black, white = engine.area_counts_plain(boards)
    plain = torch.stack([black, white, (black - white) - engine.komi])
    out = {}
    for name, m, want in (("unmasked", None, plain),
                          ("masked", mask, torch.where(mask, plain, 0.0))):
        got = score_kernels.score_area(engine, boards, m)
        same = got.view(torch.int32) == want.view(torch.int32)
        out[name] = int((~same.all(dim=0)).sum())
    return out
