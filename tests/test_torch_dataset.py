"""Parity of the port's pro-game dataset builder (``eval/dataset.py``) with
the JAX package's.

The in-repo 9x9 Go games (``logs/go/9x9_matched/sgf``, 95 SGFs) stand in
for the pro-game corpus. Both packages build the dataset from them on the
fast path (lockstep replay) and on the slow path (one host env per game):
states, target policies, values, the game count and the mismatch stats are
equal, exactly. The npz cache written by either package loads in the other.
A small planted corpus covers the filters, the score-mismatch accounting
and the per-player cap on both paths.
"""

import os
import shutil

import numpy as np
import pytest

from alpha_zero_tpu.eval import dataset as jax_dataset
from alpha_zero_tpu_torch.eval import dataset

from torch_parity import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(REPO, "logs", "go", "9x9_matched", "sgf")


def _assert_same(ref, out):
    assert out.states.dtype == np.int8 and out.states.shape[1:] == ref.states.shape[1:]
    np.testing.assert_array_equal(ref.states, out.states)
    np.testing.assert_array_equal(ref.target_pi, out.target_pi)
    np.testing.assert_array_equal(ref.target_v, out.target_v)
    assert ref.num_games == out.num_games
    assert ref.mismatch_stats == out.mismatch_stats


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "slow"])
def test_in_repo_corpus_builds_like_jax(fast):
    ref = jax_dataset.build_eval_dataset(CORPUS, 9, 8, fast=fast)
    out = dataset.build_eval_dataset(CORPUS, 9, 8, fast=fast, device="cpu")
    _assert_same(ref, out)
    assert out.num_games > 50 and len(out) > 5000
    assert set(np.unique(out.target_v)) == {-1.0, 1.0}


def test_npz_cache_round_trips_across_packages(tmp_path):
    """A cache written by the JAX package loads in the port without a
    rebuild, and one written by the port loads in the JAX package."""
    corpus = tmp_path / "sgf"
    corpus.mkdir()
    for name in sorted(os.listdir(CORPUS))[:12]:
        shutil.copy(os.path.join(CORPUS, name), corpus / name)
    cache = str(tmp_path / "cache.npz")
    for writer, reader in ((jax_dataset, dataset), (dataset, jax_dataset)):
        if os.path.exists(cache):
            os.remove(cache)
        kw = {"device": "cpu"} if writer is dataset else {}
        built = writer.build_eval_dataset(str(corpus), 9, 8, cache_path=cache, **kw)
        mtime = os.path.getmtime(cache)
        kw = {"device": "cpu"} if reader is dataset else {}
        loaded = reader.build_eval_dataset(str(corpus), 9, 8, cache_path=cache, **kw)
        assert os.path.getmtime(cache) == mtime  # loaded, not rebuilt
        _assert_same(built, loaded)
        assert 0 < loaded.num_games <= 12


def _game(black, white, result, moves, komi="0.5", size=5):
    return (f"(;CA[UTF-8]RU[Chinese]PB[{black}]PW[{white}]KM[{komi}]RE[{result}]"
            f"SZ[{size}]" + "".join(f";{c}[{m}]" for c, m in moves) + ")")


PLANTED = {
    # Valid games: black's one stone owns the board (B+24.5 at komi 0.5).
    "a_valid.sgf": _game("StrongA (2500)", "StrongB (2600)", "B+24.5",
                         [("B", "cc"), ("W", ""), ("B", "")]),
    "b_score_off.sgf": _game("StrongA (2500)", "StrongC (2600)", "B+20.5",
                             [("B", "cc"), ("W", ""), ("B", "")]),
    "c_winner_off.sgf": _game("StrongA (2500)", "StrongD (2600)", "W+3.5",
                              [("B", "cc"), ("W", ""), ("B", "")]),
    "d_resign.sgf": _game("StrongA (2500)", "StrongE (2600)", "W+R",
                          [("B", "cc"), ("W", "bb"), ("B", "dd")]),
    "e_duplicate.sgf": _game("StrongA (2500)", "StrongB (2600)", "B+24.5",
                             [("B", "cc"), ("W", ""), ("B", "")]),
    "f_illegal.sgf": _game("StrongA (2500)", "StrongF (2600)", "B+1.5",
                           [("B", "cc"), ("W", "cc")]),
    "g_out_of_turn.sgf": _game("StrongA (2500)", "StrongG (2600)", "B+1.5",
                               [("B", "cc"), ("B", "dd")]),
    "h_weak.sgf": _game("Weak (1500)", "AlsoWeak (1400)", "B+1.5", [("B", "aa")]),
    "i_timeout.sgf": _game("StrongA (2500)", "StrongH (2600)", "B+T", [("B", "aa")]),
    "j_wrong_size.sgf": _game("StrongA (2500)", "StrongI (2600)", "B+1.5", [("B", "aa")],
                              size=9),
    "k_long.sgf": _game("StrongA (2500)", "StrongJ (2600)", "W+0.5",
                        [("B", "cc"), ("W", "bc"), ("B", "dd"), ("W", "bd"),
                         ("B", "cb"), ("W", ""), ("B", "")]),
}


@pytest.mark.parametrize("fast", [True, False], ids=["fast", "slow"])
@pytest.mark.parametrize("cap", [200, 1], ids=["uncapped", "cap1"])
def test_planted_corpus_filters_like_jax(tmp_path, fast, cap):
    """Filters (weak players, timeout, board size, duplicates, illegal and
    out-of-turn games), score and winner mismatches, a resignation, and
    with ``max_games_per_player=1`` the cap on StrongA, charged in each
    path's order."""
    for name, content in PLANTED.items():
        (tmp_path / name).write_text(content)
    kw = dict(max_games_per_player=cap)
    ref = jax_dataset.build_eval_dataset(str(tmp_path), 5, 2, fast=fast, **kw)
    out = dataset.build_eval_dataset(str(tmp_path), 5, 2, fast=fast, device="cpu", **kw)
    _assert_same(ref, out)
    if cap == 200:
        assert out.num_games == 5
        assert out.mismatch_stats["winner_mismatch"] == 2  # c and k
        assert out.mismatch_stats["score_mismatch"] == 1


@pytest.mark.parametrize("skip_n", [0, 3])
def test_replay_games_batched_like_jax(skip_n):
    """The lockstep replay's transitions and komi-adjusted scores, with the
    empty-board position skipped and ``skip_n`` more."""
    builder = dataset.DatasetBuilder(9, 8, device="cpu")
    files = dataset.get_sgf_files(CORPUS)[:16]
    games = [m[:3] for m in map(builder.prefilter, files) if m is not None]
    ref = jax_dataset.replay_games_batched(9, 8, games, skip_n=skip_n)
    out = dataset.replay_games_batched(9, 8, games, skip_n=skip_n, device="cpu")
    assert len(ref) == len(out) == len(games)
    for r, o in zip(ref, out):
        assert r[1] == o[1]
        assert len(r[0]) == len(o[0])
        for (rs, rp, rv), (s, p, v) in zip(r[0], o[0]):
            np.testing.assert_array_equal(rs, s)
            np.testing.assert_array_equal(rp, p)
            assert rv == v
