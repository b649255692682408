"""Plain AlphaZero search, one game at a time: the benchmark's search
reference.

The search is michaelnny/alpha_zero's (``mcts_v2.py``), as the configured
program runs it: PUCT with ``pb_c = log((1 + N + c_base) / c_base) +
c_init`` and ``U = pb_c * P * sqrt(N) / (1 + n)``, the child's value seen
from the parent (``-W / n``), first maximum on ties, illegal moves never
chosen; Dirichlet noise mixed into the root's priors every move
(``(1 - eps) * P + eps * noise`` on legal moves, not renormalised); a
fresh root counts one visit from its own evaluation; a simulation stops at
a new edge or at a finished game, whose value is the negated reward of the
move into it; backup alternates the sign up the path; the search runs
until the root has ``num_simulations`` visits or ``max_new_sims``
simulations have run; the chosen child's subtree is the next move's tree
(subtree reuse) unless the game ended. The visit-count policy uses the
exponent clip(1 / temperature, 1, 5), with the warm-up temperature while
``step_count <= warm_up_steps``; the move is the argmax of
``log(policy) + gumbel``, pass excluded during the warm-up.

Statistics are float32 and every score is the same expression, operation
by operation, so given the same evaluations the program and this search
choose the same leaves. ``pb_c`` and ``sqrt(N)`` come from ``tables``,
computed once with PyTorch on the device the program ran on, so the log
is that device's.

Evaluations come from ``evaluate(sim, obs) -> (prior, value)``: sim -1 is
the root's evaluation. Nothing here imports the program under test.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from azbench.reference.go import Position

F32 = np.float32


@dataclasses.dataclass(frozen=True)
class SearchRules:
    num_simulations: int
    max_new_sims: int
    c_puct_base: float
    c_puct_init: float
    dirichlet_eps: float
    warm_up_steps: int
    warm_up_temperature: float
    temperature: float


def tables(rules: SearchRules, device) -> Tuple[np.ndarray, np.ndarray]:
    """(pb_c, sqrt(N)) float32 for N = 0 .. num_simulations + 1, with the
    device's own log and square root."""
    n = torch.arange(rules.num_simulations + 2, dtype=torch.float32, device=device)
    base = torch.tensor(rules.c_puct_base, dtype=torch.float32, device=device)
    pb_c = torch.log((1.0 + n + rules.c_puct_base) / base) + rules.c_puct_init
    return pb_c.cpu().numpy(), torch.sqrt(n).cpu().numpy()


class Node:
    """A position in the tree. The statistics of the edge into each child
    are kept here, at the parent, by action."""

    __slots__ = ("pos", "P", "cN", "cW", "children", "expanded")

    def __init__(self, pos: Position) -> None:
        a = pos.rules.num_actions
        self.pos = pos
        self.P = np.full(a, -1.0, F32)  # priors, -1 on illegal moves
        self.cN = np.zeros(a, F32)
        self.cW = np.zeros(a, F32)
        self.children: Dict[int, Node] = {}
        self.expanded = False


class Tree:
    """A game's search tree: the root and the root's own N and W."""

    __slots__ = ("root", "N", "W")

    def __init__(self, root: Node, n, w) -> None:
        self.root, self.N, self.W = root, F32(n), F32(w)


class SearchResult:
    __slots__ = ("child_N", "child_W", "root_Q", "tree")

    def __init__(self, child_N, child_W, root_Q, tree) -> None:
        self.child_N, self.child_W, self.root_Q, self.tree = child_N, child_W, root_Q, tree


def leaf_observation(path, leaf_pos: Position, root_history: np.ndarray) -> np.ndarray:
    """The leaf's observation: its board, its ancestors' boards on
    ``path`` (root first), then the game's boards before the root."""
    boards = [leaf_pos.board] + [node.pos.board for node in reversed(path)]
    boards += list(root_history[1:])
    return leaf_pos.observation(np.stack(boards[:len(root_history)]))


def search(rules: SearchRules, game: Position, tree: Optional[Tree], noise: np.ndarray,
           evaluate: Callable[[int, np.ndarray], Tuple[np.ndarray, float]],
           pb_c: np.ndarray, sqrt_n: np.ndarray) -> SearchResult:
    """One move's search from ``game``, reusing ``tree`` (None: fresh)."""
    legal = game.legal()
    prior0, value0 = evaluate(-1, game.observation())
    if tree is None or not tree.root.expanded:
        root = Node(game)
        root.P = np.where(legal > 0.5, prior0, F32(-1.0)).astype(F32)
        root.expanded = True
        tree = Tree(root, 1.0, value0)
    root = tree.root
    root.pos = game
    eps = rules.dirichlet_eps
    mixed = np.maximum(root.P, F32(0.0)) * F32(1.0 - eps) + (noise * legal) * F32(eps)
    root.P = np.where(legal > 0.5, mixed, F32(-1.0)).astype(F32)

    for sim in range(rules.max_new_sims):
        if tree.N >= rules.num_simulations:
            evaluate(sim, None)  # the program evaluates every lane; this one is spent
            continue
        node, n_node, path, actions = root, tree.N, [], []
        while True:
            path.append(node)
            i = int(n_node)
            u = (F32(pb_c[i]) * np.maximum(node.P, F32(0.0))) * (F32(sqrt_n[i]) / (F32(1.0) + node.cN))
            score = -(node.cW / np.maximum(node.cN, F32(1.0))) + u
            score = np.where(node.P >= 0.0, score, F32(-9999.0))
            action = int(np.argmax(score))
            actions.append(action)
            child = node.children.get(action)
            if child is None or child.pos.done:
                break
            node, n_node = child, node.cN[action]
        depth = len(path)
        if child is None:
            child = Node(node.pos.play(action))
            node.children[action] = child
            needs_eval = not child.pos.done
        else:
            needs_eval = False
        obs = leaf_observation(path, child.pos, game.history) if needs_eval else None
        prior, value = evaluate(sim, obs)
        if needs_eval:
            child.P = np.where(child.pos.legal() > 0.5, prior, F32(-1.0)).astype(F32)
            child.expanded = True
            backup = F32(value)
        else:
            backup = F32(-child.pos.reward)
        # Every edge of the path, the leaf's last, its sign alternating
        # with the distance from the leaf; then the root's own statistics.
        for j, (parent, a) in enumerate(zip(path, actions)):
            parent.cN[a] += F32(1.0)
            parent.cW[a] = parent.cW[a] + (backup if (depth - 1 - j) % 2 == 0 else -backup)
        tree.N = tree.N + F32(1.0)
        tree.W = tree.W + (backup if depth % 2 == 0 else -backup)

    child_N = root.cN * 1.0
    child_W = root.cW * 1.0
    root_q = tree.W / max(tree.N, F32(1.0))
    return SearchResult(child_N, child_W, F32(root_q), tree)


def policy(rules: SearchRules, child_N: np.ndarray, legal: np.ndarray,
           step_count: int) -> np.ndarray:
    """The visit-count policy of one move."""
    warm = step_count <= rules.warm_up_steps
    temp = rules.warm_up_temperature if warm else rules.temperature
    exponent = F32(max(1.0, min(5.0, 1.0 / temp)))
    powered = (child_N * legal) ** exponent
    total = powered.sum(dtype=F32)
    return powered / max(total, F32(1e-9)) if total > 0 else powered


def sample(rules: SearchRules, pi: np.ndarray, legal: np.ndarray, gumbel: np.ndarray,
           step_count: int, pass_move) -> int:
    """The move: argmax of log(policy) + gumbel, pass excluded in the
    warm-up, uniform over the legal moves left if the policy has none."""
    probs = pi * legal
    fallback = legal.copy()
    if pass_move is not None and step_count <= rules.warm_up_steps:
        probs = probs.copy()
        probs[pass_move] = 0.0
        if legal.sum() > 1:
            fallback[pass_move] = 0.0
    if probs.sum() <= 0:
        probs = fallback
    return int(np.argmax(gumbel + np.log(np.maximum(probs, F32(1e-30)))))


def reroot(tree: Optional[Tree], result: SearchResult, move: int,
           game_after: Position) -> Optional[Tree]:
    """The next move's tree: the chosen child's subtree, or None (fresh)
    when the game ended or the move has no node."""
    if game_after.done:
        return None
    child = result.tree.root.children.get(move)
    if child is None:
        return None
    root = result.tree.root
    return Tree(child, root.cN[move], root.cW[move])
