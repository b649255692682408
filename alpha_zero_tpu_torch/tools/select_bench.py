"""Trees, bound and timers for the select kernel K1
(``ops/tree_kernels.py:select_leaf_batched``).

- ``synthetic_trees``: search trees made with numpy from a seed, at any
  geometry. They keep the search's invariants (each (parent, action) pair
  once, children only at legal actions, unused slots with parent -1), and
  each lane is of one kind that drives the descent through one edge case:
  a long chain (deeper than a cut ``path_cap``), tied priors and tied
  children, ±0.0 priors (every score ±0.0), a terminal child on the path,
  an unexpanded root (every action illegal), and random trees with illegal
  actions and terminal nodes.
- ``grown_trees``: real go9-style trees of the port's own search.
- ``select_bound``: the least time the card could take for one call.
- ``time_select``: one call's device time warm and with L2 flushed (CUDA
  graph replays) and its back-to-back time.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from alpha_zero_tpu_torch.search import mcts
from alpha_zero_tpu_torch.training import selfplay
from alpha_zero_tpu_torch.utils.device import (F32_OPS_PER_S, HBM_BYTES_PER_S, L2_BYTES,
                                               graph_ms, time_ms)

FIELDS = ("node_N", "node_W", "node_P", "parent_index", "action_from_parent",
          "node_done", "child_P")
KINDS = ("random", "chain", "ties", "zeros", "terminal", "unexpanded")
OUTPUTS = ("parent", "action", "child", "hit_terminal", "even", "odd", "depth", "p_sel")


def select_args(tree) -> Tuple[torch.Tensor, ...]:
    """The select inputs of a ``search.mcts.Tree``, in call order."""
    return tuple(getattr(tree, f) for f in FIELDS)


# ---------------------------------------------------------------------------
# Synthetic trees
# ---------------------------------------------------------------------------


class _Lane:
    """One lane's [T] vectors and [T, A] prior rows, all slots unused."""

    def __init__(self, capacity: int, num_actions: int):
        self.N = np.zeros(capacity, np.float32)
        self.W = np.zeros(capacity, np.float32)
        self.P = np.zeros(capacity, np.float32)
        self.par = np.full(capacity, -1.0, np.float32)
        self.act = np.full(capacity, -1.0, np.float32)
        self.done = np.zeros(capacity, np.float32)
        self.rows = np.full((capacity, num_actions), -1.0, np.float32)
        self.n = 1  # slots in use; slot 0 is the root

    def add(self, parent: int, action: int, row=None, done=False) -> int:
        """A new node at ``action`` of ``parent`` (a legal, free action),
        with the edge prior read from the parent's row."""
        t = self.n
        assert self.rows[parent, action] >= 0.0 and t < len(self.N)
        self.par[t], self.act[t] = parent, action
        self.P[t] = self.rows[parent, action]
        self.done[t] = float(done)
        if row is not None:
            self.rows[t] = row
        self.n += 1
        return t

    def count_visits(self) -> None:
        """N: one visit per node plus its subtree's (parents sit below
        their children's slots)."""
        self.N[:self.n] = 1.0
        for t in range(self.n - 1, 0, -1):
            self.N[int(self.par[t])] += self.N[t]


def _prior_rows(rng, rows: int, num_actions: int) -> np.ndarray:
    """Normalized priors over a random ~80% of the actions, -1 elsewhere."""
    legal = rng.rand(rows, num_actions) < 0.8
    legal[np.arange(rows), rng.randint(num_actions, size=rows)] = True
    p = (rng.gamma(0.3, size=(rows, num_actions)) + 1e-6) * legal
    p = p / p.sum(axis=1, keepdims=True)
    return np.where(legal, p, -1.0).astype(np.float32)


def _random_lane(rng, lane: _Lane, rows: np.ndarray, done_p: float,
                 lowest_first: bool = False) -> None:
    """Random tree over a random number of slots: each new node hangs at a
    random free legal action (the lowest one with ``lowest_first``) of a
    random open node; some are terminal."""
    capacity = len(lane.N)
    target = rng.randint(1, capacity + 1)

    def free_actions(t):
        legal = np.flatnonzero(rows[t] >= 0)
        return list(legal[::-1] if lowest_first else rng.permutation(legal))

    lane.rows[0] = rows[0]
    free = {0: free_actions(0)}
    open_nodes = [0]
    while lane.n < target and open_nodes:
        i = rng.randint(len(open_nodes))
        parent = open_nodes[i]
        if not free[parent]:
            open_nodes[i] = open_nodes[-1]
            open_nodes.pop()
            continue
        done = rng.rand() < done_p
        t = lane.add(parent, free[parent].pop(), None if done else rows[lane.n], done)
        if not done:
            free[t] = free_actions(t)
            open_nodes.append(t)
    lane.count_visits()
    lane.W[:lane.n] = (rng.uniform(-1.0, 1.0, lane.n) * lane.N[:lane.n]).astype(np.float32)


def _chain_lane(rng, lane: _Lane, length: int, terminal_at: int = 0) -> None:
    """A chain root -> 1 -> ... -> length that the descent follows: each
    chain node has the best value (W = -N) and a 0.5 prior, every other
    legal action a 1e-4 prior. Three losing siblings (W = +N) hang off the
    root. With ``terminal_at``, that chain node is terminal and ends it."""
    num_actions = lane.rows.shape[1]

    def row():
        r = np.where(rng.rand(num_actions) < 0.8, 1e-4, -1.0).astype(np.float32)
        r[rng.randint(num_actions)] = 1e-4
        return r

    lane.rows[0] = row()
    cur = 0
    for k in range(1, length + 1):
        a = int(rng.choice(np.flatnonzero(lane.rows[cur] >= 0)))
        lane.rows[cur, a] = 0.5
        done = k == terminal_at
        cur = lane.add(cur, a, None if done else row(), done)
        if done:
            break
    chain_end = lane.n
    legal_root = [a for a in np.flatnonzero(lane.rows[0] >= 0)
                  if a != int(lane.act[1])]
    for a in legal_root[:min(3, len(lane.N) - lane.n)]:
        lane.add(0, int(a), row())
    lane.count_visits()
    lane.W[:lane.n] = -lane.N[:lane.n]
    lane.W[chain_end:lane.n] = lane.N[chain_end:lane.n]


def _ties_lane(rng, lane: _Lane) -> None:
    """Equal priors over the legal actions of every row, and a full
    3-ary tree filled breadth first whose siblings have equal stats: every
    score ties with its siblings', so the first maximum decides."""
    capacity, num_actions = lane.rows.shape
    legal = rng.rand(capacity, num_actions) < 0.8
    legal[:, 0] = False  # the first maximum is not simply action 0
    legal[np.arange(capacity), rng.randint(1, num_actions, size=capacity)
          if num_actions > 1 else 0] = True
    rows = np.where(legal, 1.0 / legal.sum(axis=1, keepdims=True), -1.0)
    lane.rows[0] = rows[0]
    queue = [0]
    while queue and lane.n < capacity:
        parent = queue.pop(0)
        acts = rng.permutation(np.flatnonzero(lane.rows[parent] >= 0))[:3]
        for a in acts:
            if lane.n == capacity:
                break
            queue.append(lane.add(parent, int(a), rows[lane.n]))
    lane.N[1:lane.n] = 2.0
    lane.W[1:lane.n] = -2.0
    lane.N[0] = float(lane.n)


def _zeros_lane(rng, lane: _Lane, rows: np.ndarray) -> None:
    """A random tree whose legal priors are +0.0 or -0.0 and whose values
    W are ±0.0: every score is ±0.0, and -0.0 ties +0.0. Children fill
    the lowest legal actions first, so the first maximum often has one and
    the descent goes on."""
    sign = np.where(rng.rand(*rows.shape) < 0.5, -1.0, 1.0)
    zero_rows = np.where(rows >= 0, np.copysign(0.0, sign), -1.0).astype(np.float32)
    _random_lane(rng, lane, zero_rows, done_p=0.05, lowest_first=True)
    lane.W[:lane.n] = np.copysign(0.0, rng.rand(lane.n) - 0.5).astype(np.float32)


def synthetic_trees(batch: int, capacity: int, num_actions: int, seed: int,
                    kinds=KINDS) -> Dict[str, np.ndarray]:
    """``{field: f32 array}`` of ``FIELDS`` for ``batch`` lanes of
    ``capacity`` slots and ``num_actions`` actions; lane ``b`` is of kind
    ``kinds[b % len(kinds)]`` (see the module docstring). The chains run
    ``capacity - 4`` deep, so a ``path_cap`` below that cuts them."""
    rng = np.random.RandomState(seed)
    lanes = []
    for b in range(batch):
        lane = _Lane(capacity, num_actions)
        kind = kinds[b % len(kinds)]
        if kind == "random":
            _random_lane(rng, lane, _prior_rows(rng, capacity, num_actions), done_p=0.1)
        elif kind == "chain":
            _chain_lane(rng, lane, max(1, capacity - 4))
        elif kind == "terminal":
            _chain_lane(rng, lane, max(1, capacity - 4), terminal_at=min(3, capacity - 1))
        elif kind == "ties":
            _ties_lane(rng, lane)
        elif kind == "zeros":
            _zeros_lane(rng, lane, _prior_rows(rng, capacity, num_actions))
        elif kind == "unexpanded":
            lane.N[0] = 1.0
        else:
            raise ValueError(f"unknown lane kind {kind!r}")
        lanes.append(lane)
    cols = dict(node_N="N", node_W="W", node_P="P", parent_index="par",
                action_from_parent="act", node_done="done", child_P="rows")
    return {f: np.stack([getattr(lane, cols[f]) for lane in lanes]) for f in FIELDS}


# ---------------------------------------------------------------------------
# Grown trees, bound and timers
# ---------------------------------------------------------------------------


def grown_trees(cfg, engine, net, batch: int, sims: int, max_new_sims: int,
                seed: int, device) -> Tuple[list, int]:
    """``([carried, searched], path_cap)``: the trees carried after two
    self-play moves of ``batch`` games, and the trees after one more
    search from them with root noise, at ``sims`` simulations."""
    search = dataclasses.replace(cfg.search, num_simulations=sims,
                                 max_new_sims=max_new_sims)
    step = selfplay.make_selfplay_step(engine, net, search, cfg.resign, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    sp = selfplay.init_selfplay_state(engine, batch, gen, -1.0, 0.0,
                                      reuse_num_simulations=sims, device=device)
    for _ in range(2):
        sp, _ = step(sp, gen, -1.0)
    carried = sp.trees.map(torch.clone)
    _, searched = mcts.batched_search(
        selfplay.make_eval_fn(net), engine, sp.games, sims, root_noise=True,
        generator=gen, prev_trees=sp.trees, max_new_sims=max_new_sims,
        return_trees=True)
    return [carried, searched], min(sims + 1, engine.max_steps + 2)


def select_bound(depth: torch.Tensor, batch: int, capacity: int,
                 num_actions: int) -> Dict:
    """The least time of one select call on the card, from the descent
    depths of these inputs: each input read once (``child_P`` only in the
    rows the descents visit), each output written once, and per step T
    compares (the parent scan), ~10 operations per child's score and ~8
    per action for the fresh score, legality and argmax."""
    steps = float(depth.double().sum())
    nbytes = 4 * (6 * batch * capacity + steps * num_actions + 2 * batch * capacity
                  + 5 * batch) + batch
    ops = steps * (capacity + 18 * num_actions)
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / F32_OPS_PER_S * 1e3
    bound_ms, bound_by = max((byte_ms, "bytes"), (op_ms, "operations"))
    return dict(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes, ops=ops)


def time_select(select: Callable, args, kw: Dict, reps: int) -> Dict[str, float]:
    """ms per call of ``select(*args, **kw)`` on the card: ``ms``, the
    device time from a CUDA-graph replay, warm in L2; ``cold_ms``, the same
    with L2 flushed before every call (a captured write of twice its size,
    whose own time is subtracted); ``back_to_back_ms``, back-to-back calls
    with each call's host dispatch."""
    def call():
        return select(*args, **kw)

    return dict(ms=graph_ms(call, reps), cold_ms=graph_ms(call, reps, 2 * L2_BYTES),
                back_to_back_ms=time_ms(call, reps))
