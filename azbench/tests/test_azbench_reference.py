"""The benchmark's plain reference against the port at small sizes on the
CPU, the comparison on whole runs of a tiny cell, its control, and runs
with the timed path broken underneath, which the comparison must fail."""

import numpy as np
import pytest
import torch

import azbench_tiny
from alpha_zero_tpu_torch.envs.go import GoEngine
from alpha_zero_tpu_torch.models import resnet
from alpha_zero_tpu_torch.training import selfplay
from azbench import harness
from azbench.reference import go as ref_go
from azbench.reference.nets import resnet as ref_net


@pytest.mark.parametrize("n,games,max_steps", [(5, 48, 50), (9, 16, 162)])
def test_go_matches_the_port_engine_on_random_games(n, games, max_steps):
    """Every field of random games (captures, ko, passes, ends by passes
    and by length, scores), move by move, and the observation at the end."""
    engine = GoEngine(board_size=n, num_stack=8, komi=7.5, max_steps=max_steps)
    rules = ref_go.Rules(n, 8, 7.5, max_steps)
    state = engine.init_batch(games, device="cpu")
    pos = [ref_go.Position(rules) for _ in range(games)]
    rng = np.random.default_rng(n)
    ended = 0
    for _ in range(max_steps + 1):
        moves = []
        for i, p in enumerate(pos):
            np.testing.assert_array_equal(p.legal(), state.legal[i].numpy())
            board = np.flatnonzero(p.legal()[:-1])
            pass_now = p.done or not len(board) or rng.random() < 0.05
            moves.append(n * n if pass_now else int(rng.choice(board)))
        state = engine.step_batch(state, torch.tensor(moves, dtype=torch.int32))
        pos = [p if p.done else p.play(m) for p, m in zip(pos, moves)]
        for i, p in enumerate(pos):
            assert np.array_equal(p.history, state.history[i].numpy())
            assert (p.to_play, p.ko, p.step_count, p.num_passes, p.done, p.winner) == (
                int(state.to_play[i]), int(state.ko[i]), int(state.step_count[i]),
                int(state.num_passes[i]), bool(state.done[i]), int(state.winner[i]))
            assert np.float32(p.final_score) == state.final_score[i].item()
        ended = sum(p.done for p in pos)
    assert ended == games
    obs = engine.observation(state).numpy()
    for i, p in enumerate(pos):
        np.testing.assert_array_equal(p.observation(), obs[i])


def test_net_matches_the_port_net_in_float32():
    cfg = {**azbench_tiny.config()["env"], **azbench_tiny.config()["network"]}
    w = ref_net.calibrated_weights(cfg, 123, "cpu")
    from alpha_zero_tpu_torch.config import EnvConfig, NetworkConfig

    net = resnet.build_network(EnvConfig(board_size=5), NetworkConfig(
        num_res_blocks=2, num_filters=16, num_fc_units=16), device="cpu", dtype="float32")
    missing, unexpected = net.load_state_dict(w, strict=False)
    assert not unexpected and all(k.endswith("num_batches_tracked") for k in missing)
    obs = ref_net.calibration_boards(cfg, 64, 5, "cpu")
    with torch.no_grad():
        out = net(obs)
    logits, value = ref_net.forward(w, cfg, obs)
    torch.testing.assert_close(out.pi_logits, logits, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(out.value, value, rtol=1e-5, atol=1e-5)
    # Calibrated statistics spread the policy as a trained net's would.
    assert float(torch.softmax(logits, -1).max(-1).values.mean()) < 0.5


@pytest.mark.parametrize("seed", [3, 2**31 + 11])
def test_tiny_runs_are_correct(seed):
    out = harness.drive(azbench_tiny.run(seed))
    assert out.correct, out.checks
    assert out.checks["search_pi_gap"]["value"] < 1e-6
    assert out.attempted > 0 and out.failed == 0


def test_tiny_run_in_bf16_is_correct():
    out = harness.drive(azbench_tiny.run(5, dtype="bfloat16", batch=24))
    assert out.correct, out.checks
    assert out.checks["policy_tv"]["value"] > 1e-4  # the rounding shows, under its limit


def test_control_fails():
    """The reference net in fp8 and the policy in bf16, in the program's
    place: the comparison must say not correct."""
    out = harness.drive(azbench_tiny.run(5, control=True, dtype="bfloat16", batch=24))
    assert not out.correct
    failing = {k for k, c in out.checks.items() if c["value"] > c["limit"]}
    assert {"policy_tv", "value_mae", "search_pi_gap"} <= failing, out.checks


def _broken(monkeypatch, fault):
    """The program's self-play step with ``fault`` planted in it."""
    make = selfplay.make_selfplay_step

    def make_broken(engine, net, *args, **kwargs):
        step = make(engine, net, *args, **kwargs)

        def broken(sp, generator=None, threshold=-1.0, noise=None):
            new, out = step(sp, generator, threshold, noise=noise)
            return fault(sp, new, out)
        return broken

    monkeypatch.setattr(selfplay, "make_selfplay_step", make_broken)


def _state_unchanged(sp, new, out):
    return sp, out


def _half_batch(sp, new, out):
    """The second half of the games skipped: they keep their state."""
    half = sp.games.board.shape[0] // 2

    def keep(n, o):
        n = n.clone()
        n[half:] = o[half:]
        return n
    games = new.games.map2(sp.games, keep)
    return selfplay.SelfplayState(games, new.resign_disabled, new.marked_resign_player,
                                  new.trees), out


def _answer_altered(sp, new, out):
    """Every game's recorded policy moved toward uniform where produced."""
    pi = out.search_pi * 0.9 + 0.1 / out.search_pi.shape[-1]
    return new, out._replace(search_pi=pi)


def _move_altered(sp, new, out):
    """The move reported is the next legal one, not the one played."""
    legal = sp.games.legal
    nxt = (out.move + 1) % legal.shape[-1]
    return new, out._replace(move=torch.where(legal.gather(1, nxt[:, None].long())[:, 0] > 0, nxt,
                                              out.move))


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered, _move_altered],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_step_is_not_correct(monkeypatch, fault):
    _broken(monkeypatch, fault)
    out = harness.drive(azbench_tiny.run(7, batch=16, lanes=16))
    assert not out.correct, out.checks


def test_traced_tiny_run_reads_the_stretch():
    """The traced path on the CPU: the stretch's K1 depths and K2 sets are
    taken as the search hands them, and the kernels' counters and names are
    left as they were."""
    from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels

    select, write = tree_kernels.select_leaf_batched, scatter_kernels.write_rows
    out = harness.drive(azbench_tiny.run(4, trace=True))
    assert out.correct, out.checks
    assert tree_kernels.select_leaf_batched is select and scatter_kernels.write_rows is write
    assert out.trace["k1_bound_s"] > 0 and out.trace["k2_bound_s"] > 0
    assert out.trace["mfu_seconds"] > 0 and out.trace["conv_flops"] > 0
