"""The scoring kernel's wrapper (``alpha_zero_tpu_torch/ops/score_kernels.py``)
on the CPU, where it runs the plain version: masked scoring equal to
``area_counts`` on the selected lanes and 0 elsewhere, ``_finalize_scores``
filling only the lanes that just ended, and the wrapper's checks. The
kernel itself is held to the plain version in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.ops import score_kernels
from alpha_zero_tpu_torch.tools.score_boards import played_boards, snake_boards


def _random(n, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.choice(np.array([-1, 0, 1], np.int8), (16, n, n),
                                       p=[0.3, 0.4, 0.3]))


def _one(board, copies=8):
    return torch.from_numpy(np.ascontiguousarray(np.repeat(board[None], copies, 0)))


def _single(n):
    board = np.zeros((n, n), np.int8)
    board[n // 2, n // 2] = 1
    return _one(board)


def _full(n):
    return _one(np.where(np.add.outer(np.arange(n), np.arange(n)) % 3, 1, -1).astype(np.int8))


# (board size, boards, each board's (black, white) areas where known).
CASES = {
    "random9": lambda: (9, _random(9, 0), None),
    "random13": lambda: (13, _random(13, 1), None),
    "random19": lambda: (19, _random(19, 2), None),
    "played9": lambda: (9, played_boards(GoEngine(9), 16, 60, 3, "cpu"), None),
    "empty19": lambda: (19, _one(np.zeros((19, 19), np.int8)), ([0] * 8, [0] * 8)),
    "full9": lambda: (9, _full(9), ([54] * 8, [27] * 8)),
    "single_stone13": lambda: (13, _single(13), ([169] * 8, [0] * 8)),
    "snake9": lambda: (9, snake_boards(9), ([81, 0, 31, 54, 81, 31], [0, 81, 1, 8, 0, 1])),
    "snake19": lambda: (19, snake_boards(19),
                        ([361, 0, 161, 190, 361, 161], [0, 361, 1, 72, 0, 1])),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_masked_scoring_equals_area_counts_on_the_selected_lanes(case):
    n, boards, areas = CASES[case]()
    engine = GoEngine(board_size=n)
    b = boards.shape[0]
    black, white = engine.area_counts(boards)
    if areas is not None:
        assert (black.tolist(), white.tolist()) == areas
    lane = torch.arange(b)
    mask = lane % 3 != 1
    got = score_kernels.score_area(engine, boards, mask)
    want = torch.stack([black, white, (black - white) - engine.komi])
    assert torch.equal(got[:, mask], want[:, mask])
    assert torch.equal(got[:, ~mask], torch.zeros((3, int((~mask).sum()))))
    assert torch.equal(engine.score(boards), want[2])

    # Lanes by i % 4: just ended (scored), resigned, over before the step,
    # still playing. Only the first kind is filled; the others keep what
    # step_core set.
    kind = lane % 4
    games = engine.init_batch(b, device="cpu")
    stepped = games.replace(
        board=boards, done=kind != 3, resigned=kind == 1,
        to_play=torch.where(lane % 2 == 0, 1, -1).to(torch.int8),
        winner=torch.full((b,), 7, dtype=torch.int8),
        last_reward=torch.full((b,), 0.25), final_score=torch.full((b,), 99.0))
    out = engine._finalize_scores(kind == 2, stepped)
    needs = kind == 0
    mover = -stepped.to_play
    sign = torch.sign(want[2]).to(torch.int8)
    assert torch.equal(out.final_score[needs], want[2][needs])
    assert torch.equal(out.winner[needs], sign[needs])
    assert torch.equal(out.last_reward[needs],
                       torch.where(sign == 0, 0.0, torch.where(sign == mover, 1.0, -1.0))[needs])
    assert (out.winner[~needs] == 7).all() and (out.last_reward[~needs] == 0.25).all()
    assert (out.final_score[~needs] == 99.0).all()
    assert torch.equal(out.board, boards)


@pytest.mark.parametrize("case", ["plain_path", "too_large", "int32_board", "mask_shape"])
def test_wrapper_on_the_cpu(case):
    engine = GoEngine(board_size=33 if case == "too_large" else 9)
    n = engine.board_size
    boards = torch.zeros((2, n, n), dtype=torch.int32 if case == "int32_board" else torch.int8)
    mask = torch.ones((3 if case == "mask_shape" else 2,), dtype=torch.bool)
    if case == "plain_path":
        before = score_kernels.score_area.launches
        boards[0, 4, 4] = 1
        got = score_kernels.score_area(engine, boards, mask)
        assert score_kernels.score_area.launches == before
        assert got.tolist() == [[81.0, 0.0], [0.0, 0.0], [73.5, -7.5]]
        return
    with pytest.raises(TypeError if case == "int32_board" else ValueError,
                       match="int8" if case == "int32_board" else
                       "N \\* N <= 1024" if case == "too_large" else "mask"):
        score_kernels.score_area(engine, boards, mask)
