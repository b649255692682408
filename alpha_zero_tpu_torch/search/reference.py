"""Self-contained object-tree MCTS — the CPU correctness oracle.

The port of ``alpha_zero_tpu.search.reference``: a slow, obviously-correct
serial search for cross-checking the batched search (``search/mcts.py``)
in tests and debugging. It keeps the same numpy host tree and the same
PUCT, backup and root-Q arithmetic, steps the port's engines one game (a
batch of 1) at a time through ``engine.step`` and ``engine.observation``,
and runs on the device of the state it is given. It is NOT a production
code path.
"""

from __future__ import annotations

import collections
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np


class Node:
    """One search-tree node; child stats stored at the parent (minigo layout)."""

    __slots__ = ("to_play", "move", "parent", "num_actions", "is_expanded",
                 "child_W", "child_N", "child_P", "children")

    def __init__(self, to_play: int, num_actions: int, move: Optional[int] = None,
                 parent=None) -> None:
        self.to_play = to_play
        self.move = move
        self.parent = parent
        self.num_actions = num_actions
        self.is_expanded = False
        self.child_W = np.zeros(num_actions, dtype=np.float32)
        self.child_N = np.zeros(num_actions, dtype=np.float32)
        self.child_P = np.zeros(num_actions, dtype=np.float32)
        self.children: Dict[int, "Node"] = {}

    @property
    def N(self) -> float:
        return self.parent.child_N[self.move]

    @N.setter
    def N(self, value) -> None:
        self.parent.child_N[self.move] = value

    @property
    def W(self) -> float:
        return self.parent.child_W[self.move]

    @W.setter
    def W(self, value) -> None:
        self.parent.child_W[self.move] = value

    def child_U(self, c_puct_base: float, c_puct_init: float) -> np.ndarray:
        pb_c = math.log((1 + self.N + c_puct_base) / c_puct_base) + c_puct_init
        return pb_c * self.child_P * (math.sqrt(self.N) / (1 + self.child_N))

    def child_Q(self) -> np.ndarray:
        child_n = np.where(self.child_N > 0, self.child_N, 1)
        return self.child_W / child_n


class DummyNode:
    """The root's parent: holds the root's N and W."""

    def __init__(self) -> None:
        self.parent = None
        self.child_W = collections.defaultdict(float)
        self.child_N = collections.defaultdict(float)


def backup(node: Node, value: float) -> None:
    while isinstance(node, Node):
        node.N += 1
        node.W += value
        node = node.parent
        value = -value


def oracle_search(
    engine,
    state,
    eval_func: Callable[[np.ndarray], Tuple[np.ndarray, float]],
    num_simulations: int,
    c_puct_base: float = 19652.0,
    c_puct_init: float = 1.25,
) -> Tuple[np.ndarray, float]:
    """Serial UCT from ``state`` (one game, a batch of 1); returns (root
    child_N, root Q).

    ``eval_func(obs_nhwc) -> (pi_probs[A], value)`` takes one game's
    observation, int8 [N, N, C]. Legality is read from ``state.legal``.
    """

    def obs_np(s):
        return engine.observation(s)[0].cpu().numpy()

    def legal_np(s):
        return s.legal[0].cpu().numpy()

    prior, value = eval_func(obs_np(state))
    root = Node(to_play=int(state.to_play[0]), num_actions=engine.num_actions,
                parent=DummyNode())
    root.child_P = np.asarray(prior, np.float32).copy()
    root.is_expanded = True
    backup(root, float(value))

    while root.N < num_simulations:
        node = root
        sim_state = state
        done = bool(sim_state.done[0])
        reward = 0.0
        while node.is_expanded:
            scores = -node.child_Q() + node.child_U(c_puct_base, c_puct_init)
            scores = np.where(legal_np(sim_state) == 1, scores, -9999)
            move = int(np.argmax(scores))
            if move not in node.children:
                node.children[move] = Node(
                    to_play=-int(sim_state.to_play[0]), num_actions=engine.num_actions,
                    move=move, parent=node,
                )
            node = node.children[move]
            sim_state = engine.step(sim_state, move)
            done = bool(sim_state.done[0])
            reward = float(sim_state.last_reward[0])
            if done:
                break
        if done:
            backup(node, -reward)
            continue
        prior, value = eval_func(obs_np(sim_state))
        node.child_P = np.asarray(prior, np.float32).copy()
        node.is_expanded = True
        backup(node, float(value))

    root_q = root.W / root.N
    return root.child_N.copy(), float(root_q)
