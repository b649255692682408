"""Batched MCTS over fixed-capacity array trees.

The port of ``alpha_zero_tpu.search.mcts``: the same tree layout (node-indexed
visit/value stats, ``child_P`` rows with a -1 illegal sentinel, parent/action
vectors and no children array, slots filled in creation order), the same
simulation loop, budget, subtree reuse and root statistics, so every count
and value matches the JAX package.

Where the JAX package chose one-hot matmuls for the TPU, this port uses the
gather lowerings the JAX package also carries (``_gather_state_rows``,
``_materialize_scatter``, ``_expand_backup_scatter``, the gather branch of
``_leaf_history_batch``): every step touches only the rows it needs. Select
always goes through ``ops.tree_kernels.select_leaf_batched``, and the tree
writes of a simulation (13 arrays when a node is materialized, 2 when it is
expanded) through one ``ops.scatter_kernels.write_rows`` call each — the
CUDA kernels on the card, their plain versions on the CPU.

The search updates its trees IN PLACE (a simulation writes one row per game
instead of copying the ``[B, T, A]`` prior array): ``batched_search`` takes
ownership of ``prev_trees``.

Randomness comes in as tensors (the Dirichlet draw) or from an explicit
``torch.Generator``; ``jax.random`` streams cannot be reproduced, so tests
feed the JAX package's draws to both.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, NamedTuple, Optional, Tuple

import torch

from alpha_zero_tpu_torch.envs.types import GameState, TensorStruct
from alpha_zero_tpu_torch.ops import scatter_kernels, tree_kernels
from alpha_zero_tpu_torch.utils import trace


@dataclasses.dataclass
class NodeState(TensorStruct):
    """The per-node game state stored in the tree, ``[B, T, ...]``: exactly
    the fields ``GoEngine.step_core`` reads (see ``_game_state_of``)."""

    board: torch.Tensor        # int8[B, T, N, N]
    labels: torch.Tensor       # int8 (int16 above 11x11) [B, T, N, N]
    group_libs: torch.Tensor   # int8 / int16 [B, T, N*N + 1]
    to_play: torch.Tensor      # int8[B, T]
    pass_streak: torch.Tensor  # int32[B, T]
    step_count: torch.Tensor   # int32[B, T]


def _node_state_of(gs: GameState) -> NodeState:
    """GameState -> NodeState. Labels and liberty counts are bounded by
    N*N, so they fit int8 up to 11x11 boards and int16 above."""
    n = gs.board.shape[-1]
    idt = torch.int8 if n * n <= 127 else torch.int16
    return NodeState(
        board=gs.board,
        labels=gs.labels.to(idt),
        group_libs=gs.group_libs.to(idt),
        to_play=gs.to_play,
        pass_streak=gs.pass_streak,
        step_count=gs.step_count,
    )


def _game_state_of(ns: NodeState, num_actions: int) -> GameState:
    """A full batched GameState for the engine step from stored node
    fields ``[B, ...]``. The dummied fields are either never read by
    ``step_core`` (legal, ko, history beyond the board) or read and
    discarded (captures, num_passes, done=False): selection never expands a
    terminal node, and the expanded child's counters are never read back."""
    b = ns.board.shape[0]
    dev = ns.board.device

    def full(shape, value, dtype):
        return torch.full((b,) + shape, value, dtype=dtype, device=dev)

    return GameState(
        board=ns.board,
        history=ns.board[:, None],
        to_play=ns.to_play,
        step_count=ns.step_count,
        done=full((), False, torch.bool),
        winner=full((), 0, torch.int8),
        last_move=full((), -2, torch.int32),
        last_reward=full((), 0.0, torch.float32),
        ko=full((), -1, torch.int32),
        pass_streak=ns.pass_streak,
        num_passes=full((), 0, torch.int32),
        captures=full((2,), 0, torch.int32),
        resigned=full((), False, torch.bool),
        final_score=full((), 0.0, torch.float32),
        labels=ns.labels.float(),
        group_libs=ns.group_libs.float(),
        legal=full((num_actions,), 0.0, torch.float32),
    )


@dataclasses.dataclass
class Tree(TensorStruct):
    """Fixed-capacity search trees for B games, ``[B, T, ...]``.

    T = num_simulations + 1 node slots; slot 0 is the root; new nodes fill
    slots in creation order (``num_nodes`` is the next free slot), so a
    parent's slot is always below its children's — what re-rooting relies on.
    """

    _nested: ClassVar[Dict[str, type]] = {"states": NodeState}

    node_N: torch.Tensor              # f32[B, T] visits of the edge into each node
    node_W: torch.Tensor              # f32[B, T] value sum (node-player view)
    node_P: torch.Tensor              # f32[B, T] prior of the edge into each node
    child_P: torch.Tensor             # f32[B, T, A] child priors; -1 = illegal
    parent_index: torch.Tensor        # f32[B, T]; -1 for the root / unused slots
    action_from_parent: torch.Tensor  # f32[B, T]; -1 for the root / unused slots
    node_expanded: torch.Tensor       # bool[B, T]; has priors
    node_done: torch.Tensor           # f32[B, T]; 1.0 when the game is over
    node_reward: torch.Tensor         # f32[B, T]; reward of the creating step
    states: NodeState                 # [B, T, ...] node states
    root_legal: torch.Tensor          # f32[B, A]; the root's legal mask
    root_history: torch.Tensor        # int8[B, S, N, N]; the root's history
    num_nodes: torch.Tensor           # f32[B]; next free slot


class SearchResult(NamedTuple):
    """Root statistics after the simulation budget is spent."""

    child_N: torch.Tensor  # [B, A] root child visit counts
    child_W: torch.Tensor  # [B, A] root child total values
    root_Q: torch.Tensor   # [B] root mean value (root player's perspective)
    legal: torch.Tensor    # [B, A] root legal mask


def _rows(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Pads ``x`` with trailing unit dims to ``ndim`` dims, for broadcasting
    a per-game [B] or per-node [B, T] mask over a wider leaf."""
    return x.reshape(x.shape + (1,) * (ndim - x.dim()))


def _gather_state_rows(states: NodeState, idx: torch.Tensor) -> NodeState:
    """``states[b, idx[b]]`` for every leaf: one row gather per game."""
    bidx = torch.arange(idx.shape[0], device=idx.device)
    return states.map(lambda leaf: leaf[bidx, idx.long()])


def _leaf_history_batch(tree: Tree, parent: torch.Tensor, depth: torch.Tensor,
                        new_board: torch.Tensor, num_stack: int) -> torch.Tensor:
    """Every leaf's [S, N, N] board history (latest first), ``[B, S, N, N]``.

    Plane 0 is the leaf's own board; plane k comes from the k-th ancestor's
    board while that ancestor is in the tree (k <= depth), then from the
    root's pre-search history (``root_history[k - depth]``)."""
    if num_stack == 1:
        return new_board[:, None]
    batch, capacity = tree.node_N.shape
    dev = new_board.device

    # Ancestor ids [B, S-1] by walking the parent pointers.
    ids = [parent.float()]
    for _ in range(2, num_stack):
        walk = ids[-1].clamp(0.0, capacity - 1).long()
        nxt = tree.parent_index.gather(1, walk[:, None])[:, 0]
        ids.append(torch.where(ids[-1] >= 0, nxt, -1.0))
    anc = torch.stack(ids, dim=1)

    ks = torch.arange(1, num_stack, device=dev)
    depth = depth.long()
    from_tree = (ks[None, :] <= depth[:, None]) & (anc >= 0)
    anc_i = anc.clamp(0.0, capacity - 1).long()
    rh_idx = (ks[None, :] - depth[:, None]).clamp(0, num_stack - 1)

    boards = tree.states.board.reshape(batch, capacity, -1)
    cells = boards.shape[-1]
    tree_planes = boards.gather(1, anc_i[:, :, None].expand(-1, -1, cells))
    roots = tree.root_history.reshape(batch, num_stack, -1)
    root_planes = roots.gather(1, rh_idx[:, :, None].expand(-1, -1, cells))
    older = torch.where(from_tree[:, :, None], tree_planes, root_planes)
    older = older.reshape((batch, num_stack - 1) + new_board.shape[1:])
    return torch.cat([new_board[:, None], older], dim=1)


# ---------------------------------------------------------------------------
# Tree construction
# ---------------------------------------------------------------------------


def make_empty_trees(engine, root_states: GameState, num_simulations: int) -> Tree:
    """Fresh trees holding only an unexpanded root per game (every tensor
    its own storage, so the search can write into it)."""
    return _empty_trees(root_states, num_simulations + 1, engine.num_actions)


def _empty_trees(root_states: GameState, capacity: int, num_actions: int) -> Tree:
    b = root_states.board.shape[0]
    dev = root_states.board.device
    node = _node_state_of(root_states)
    states = node.map(
        lambda x: x[:, None].expand((b, capacity) + x.shape[1:]).contiguous())

    def full(shape, value, dtype=torch.float32):
        return torch.full((b,) + shape, value, dtype=dtype, device=dev)

    return Tree(
        node_N=full((capacity,), 0.0),
        node_W=full((capacity,), 0.0),
        node_P=full((capacity,), 0.0),
        child_P=full((capacity, num_actions), -1.0),
        parent_index=full((capacity,), -1.0),
        action_from_parent=full((capacity,), -1.0),
        node_expanded=full((capacity,), False, torch.bool),
        node_done=full((capacity,), 0.0),
        node_reward=full((capacity,), 0.0),
        states=states,
        root_legal=root_states.legal.clone(),
        root_history=root_states.history.clone(),
        num_nodes=full((), 1.0),
    )


def _init_root(tree: Tree, prior: torch.Tensor, value: torch.Tensor) -> Tree:
    """Expands and backs up each root that is fresh; a reused root keeps its
    carried stats. The stored prior keeps the -1 illegal sentinel. In place."""
    fresh = ~tree.node_expanded[:, 0]
    prior_sel = torch.where(tree.root_legal > 0.5, prior, -1.0)
    tree.node_N[:, 0] = torch.where(fresh, 1.0, tree.node_N[:, 0])
    tree.node_W[:, 0] = torch.where(fresh, value, tree.node_W[:, 0])
    tree.child_P[:, 0] = torch.where(fresh[:, None], prior_sel, tree.child_P[:, 0])
    tree.node_expanded[:, 0] = True
    return tree


def dirichlet_draw(generator: Optional[torch.Generator], batch: int,
                   num_actions: int, alpha: float, device) -> torch.Tensor:
    """One Dirichlet(alpha, ..., alpha) draw over all actions per game.
    (``torch.distributions.Dirichlet`` takes no generator.)"""
    conc = torch.full((batch, num_actions), alpha, dtype=torch.float32,
                      device=device)
    return torch._sample_dirichlet(conc, generator=generator)


def _add_dirichlet_noise(tree: Tree, noise: torch.Tensor, eps: float) -> Tree:
    """Root exploration noise from the draw ``noise [B, A]``: masked by
    legality, not renormalized. Applied every search, also to reused roots,
    whose existing children's ``node_P`` take the noised priors. In place."""
    num_actions = tree.child_P.shape[-1]
    legal = tree.root_legal > 0.5
    noise = noise * tree.root_legal
    new_p = torch.clamp_min(tree.child_P[:, 0], 0.0) * (1.0 - eps) + noise * eps
    row0 = torch.where(legal, new_p, -1.0)
    act = tree.action_from_parent.clamp(0, num_actions - 1).long()
    p_of_action = row0.gather(1, act)  # [B, T]
    tree.node_P.copy_(torch.where(tree.parent_index == 0.0, p_of_action, tree.node_P))
    tree.child_P[:, 0] = row0
    return tree


# ---------------------------------------------------------------------------
# Materialize + expand/backup (around the batch-level step and NN eval)
# ---------------------------------------------------------------------------


def materialize_arrays(tree: Tree) -> list:
    """The 13 arrays a materialize write sets, in order: the ``NodeState``
    fields, parent_index, action_from_parent, node_done, node_reward,
    node_N, node_W, node_P."""
    return [getattr(tree.states, f.name) for f in dataclasses.fields(NodeState)] + [
        tree.parent_index, tree.action_from_parent, tree.node_done, tree.node_reward,
        tree.node_N, tree.node_W, tree.node_P]


def _materialize_scatter(tree: Tree, slot: torch.Tensor, parent: torch.Tensor,
                         action: torch.Tensor, existing_child: torch.Tensor,
                         hit_terminal: torch.Tensor, active: torch.Tensor,
                         new_node: NodeState, new_done: torch.Tensor,
                         new_reward: torch.Tensor, edge_prior: torch.Tensor):
    """Writes each lane's freshly stepped leaf into its next free ``slot``;
    allocates nothing where selection hit an existing terminal node or the
    lane's budget is spent. In place. Returns (tree, leaf, needs_eval)."""
    batch, capacity = tree.node_N.shape
    is_new = ~hit_terminal & active & (slot < capacity)
    slot_i = slot.clamp(0, capacity - 1).long()

    zeros = torch.zeros((batch,), device=slot.device)
    rows = [getattr(new_node, f.name) for f in dataclasses.fields(NodeState)]
    rows += [parent, action, new_done, new_reward, zeros, zeros, edge_prior]
    arrays = materialize_arrays(tree)
    scatter_kernels.write_rows(
        arrays, [r.to(arr.dtype).contiguous() for arr, r in zip(arrays, rows)],
        torch.where(is_new, slot_i, -1).to(torch.int32))
    tree.num_nodes.add_(is_new.float())
    leaf = torch.where(is_new, slot_i, existing_child.clamp(0, capacity - 1).long())
    needs_eval = is_new & ~new_done
    return tree, leaf, needs_eval


def _expand_backup_scatter(tree: Tree, slot: torch.Tensor, leaf: torch.Tensor,
                           needs_eval: torch.Tensor, active: torch.Tensor,
                           even: torch.Tensor, odd: torch.Tensor,
                           leaf_depth: torch.Tensor, prior: torch.Tensor,
                           value: torch.Tensor) -> Tree:
    """Writes each evaluated leaf's prior row and backs up the NN value, or
    ``-reward`` at a terminal leaf (the reward belongs to the player who made
    the terminal move), sign-alternating up the recorded path. Lanes whose
    budget is spent change nothing. In place."""
    batch, capacity = tree.node_N.shape
    slot_i = slot.clamp(0, capacity - 1).long()
    scatter_kernels.write_rows(
        [tree.child_P, tree.node_expanded],
        [prior.to(tree.child_P.dtype).contiguous(), torch.ones_like(needs_eval)],
        torch.where(needs_eval, slot_i, -1).to(torch.int32))

    act = active.float()
    term_reward = tree.node_reward.gather(1, leaf[:, None].long())[:, 0]
    backup_value = torch.where(needs_eval, value, -term_reward)
    t_iota = torch.arange(capacity, device=slot.device)
    leaf_oh = (t_iota[None, :] == leaf[:, None]).float() * act[:, None]
    d_sign = torch.where(leaf_depth % 2 == 0, 1.0, -1.0)
    path = (even - odd) * act[:, None]
    path_w = (backup_value * d_sign)[:, None] * path
    tree.node_N.add_((even + odd) * act[:, None]).add_(leaf_oh)
    tree.node_W.add_(path_w).add_(backup_value[:, None] * leaf_oh)
    return tree


# ---------------------------------------------------------------------------
# Subtree re-rooting (reuse across moves)
# ---------------------------------------------------------------------------


def _descendant_mask(parent_index: torch.Tensor, root: torch.Tensor) -> torch.Tensor:
    """0/1 f32[B, T] mask of ``root [B]`` and all its descendants, by
    pointer doubling over the parent chains (ceil(log2 T) rounds)."""
    capacity = parent_index.shape[1]
    t_iota = torch.arange(capacity, device=parent_index.device)
    desc = (t_iota[None, :] == root[:, None]).float()
    par = parent_index
    for _ in range(max(1, (capacity - 1).bit_length())):
        par_i = par.clamp(0.0, capacity - 1).long()
        valid = par >= 0
        desc = torch.maximum(desc, desc.gather(1, par_i) * valid.float())
        par = torch.where(valid, par.gather(1, par_i), -1.0)
    return desc


def reroot_trees(trees: Tree, move: torch.Tensor, done: torch.Tensor,
                 new_root_states: GameState, num_actions: int) -> Tree:
    """Promotes each game's chosen child subtree to the root after the real
    games stepped with ``move``.

    The child's descendants are compacted into slots [0, m) in creation
    order, so the child lands at slot 0, with their N/W/P carried as they
    are; slots from m on are zero (parent/action -1). Games that just ended
    (``done``; ``new_root_states`` are post-step, post-auto-reset), resigned,
    or whose move has no node get a fresh tree. Slot 0's state is the real
    post-move state."""
    batch, capacity = trees.node_N.shape
    t_iota = torch.arange(capacity, device=move.device)

    link = (trees.parent_index == 0.0) & (
        trees.action_from_parent == move[:, None].float())
    child = link.float().argmax(dim=1)  # (parent, action) pairs are unique
    valid = ~done & (move >= 0) & link.any(dim=1)

    desc = _descendant_mask(trees.parent_index, child)
    newidx = torch.where(desc > 0, torch.cumsum(desc, dim=1) - 1.0, -1.0)
    m_count = desc.sum(dim=1)
    in_use = t_iota[None, :] < m_count[:, None]
    # The old slot of every new slot: invert newidx (non-descendants land in
    # a dump column T), then move every [B, T, ...] leaf with one gather.
    dest = torch.where(desc > 0, newidx, float(capacity)).long()
    src = torch.zeros((batch, capacity + 1), dtype=torch.long,
                      device=move.device).scatter_(
        1, dest, t_iota.expand(batch, -1))[:, :capacity]

    def move_rows(x: torch.Tensor) -> torch.Tensor:
        moved = x.gather(1, _rows(src, x.dim()).expand(x.shape))
        return torch.where(_rows(in_use, x.dim()), moved, torch.zeros_like(moved))

    old_parent = trees.parent_index.clamp(0.0, capacity - 1).long()
    remapped = torch.where(trees.parent_index >= 0,
                           newidx.gather(1, old_parent), -1.0)
    action_from_parent = torch.where(in_use, move_rows(trees.action_from_parent), -1.0)
    action_from_parent[:, 0] = -1.0
    rerooted = Tree(
        node_N=move_rows(trees.node_N),
        node_W=move_rows(trees.node_W),
        node_P=move_rows(trees.node_P),
        child_P=move_rows(trees.child_P),
        parent_index=torch.where(in_use, move_rows(remapped), -1.0),
        action_from_parent=action_from_parent,
        node_expanded=move_rows(trees.node_expanded),
        node_done=move_rows(trees.node_done),
        node_reward=move_rows(trees.node_reward),
        states=trees.states.map(move_rows),
        root_legal=new_root_states.legal,
        root_history=new_root_states.history,
        num_nodes=m_count,
    )
    fresh = _empty_trees(new_root_states, capacity, num_actions)
    out = rerooted.map2(fresh, lambda r, f: torch.where(_rows(valid, r.dim()), r, f))
    root = _node_state_of(new_root_states)
    for f in dataclasses.fields(NodeState):
        getattr(out.states, f.name)[:, 0] = getattr(root, f.name)
    return out


# ---------------------------------------------------------------------------
# Full search
# ---------------------------------------------------------------------------


def batched_search(
    eval_fn: Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]],
    engine,
    root_states: GameState,
    num_simulations: int,
    c_puct_base: float = 19652.0,
    c_puct_init: float = 1.25,
    root_noise: bool = False,
    dirichlet_eps: float = 0.25,
    dirichlet_alpha: float = 0.03,
    dirichlet_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    prev_trees: Optional[Tree] = None,
    max_new_sims: Optional[int] = None,
    return_trees: bool = False,
):
    """Runs MCTS for a batch of games; one batched NN eval per simulation.

    ``eval_fn(obs int8[B, N, N, C]) -> (pi_probs f32[B, A], value f32[B])``:
    a softmaxed policy over all actions and the value from the current
    player's view.

    The visit budget is the reference's ``while root.N < num_simulations``:
    a fresh root starts at N=1, so a fresh tree runs num_simulations - 1
    simulations; reused roots (``prev_trees``, which the search updates in
    place) carry visits and their lanes stop early. ``max_new_sims`` caps
    the loop length. With ``root_noise``, the Dirichlet draw is
    ``dirichlet_noise [B, A]``, or is drawn from ``generator``.

    Returns the SearchResult, plus the post-search trees when
    ``return_trees`` (feed them through ``reroot_trees`` into the next call).
    """
    capacity = num_simulations + 1
    # A path can't outgrow the tree depth nor the game length.
    path_cap = min(num_simulations + 1, engine.max_steps + 2)
    num_stack = engine.num_stack
    num_actions = engine.num_actions
    batch = root_states.board.shape[0]

    with trace.span("search.root_eval"):
        prior0, value0 = eval_fn(engine.observation(root_states))
    # Tree nodes hold 1-deep history (their board); observation stacks are
    # rebuilt from ancestor boards and the root's pre-search history.
    tree_engine = engine.with_num_stack(1)
    trees = (make_empty_trees(engine, root_states, num_simulations)
             if prev_trees is None else prev_trees)
    _init_root(trees, prior0, value0)
    if root_noise:
        if dirichlet_noise is None:
            dirichlet_noise = dirichlet_draw(generator, batch, num_actions,
                                             dirichlet_alpha, value0.device)
        _add_dirichlet_noise(trees, dirichlet_noise, dirichlet_eps)

    loop_len = num_simulations - 1 if max_new_sims is None else max_new_sims
    search_index = trace.count("search.calls")
    if search_index is not None:
        # Every active simulation adds one root visit, so a lane is active
        # in simulation i iff its root started below num_simulations - i:
        # the loop's active lanes a simulation, from one reduction.
        left = float(num_simulations) - trees.node_N[:, 0]
        sims = torch.arange(loop_len, device=left.device, dtype=left.dtype)
        active_by_sim = (left[None, :] > sims[:, None]).sum(dim=1)
    for i in range(loop_len):
        with trace.span("search.sim", search_index, i):
            if search_index is not None:
                trace.count("search.lane_sims", batch)
                trace.count("search.active_lane_sims", active_by_sim[i])
            active = trees.node_N[:, 0] < float(num_simulations)
            with trace.span("search.select"):
                slot = trees.num_nodes.long()
                parent, action, child, hit_term, even, odd, depth, p_sel = (
                    tree_kernels.select_leaf_batched(
                        trees.node_N, trees.node_W, trees.node_P, trees.parent_index,
                        trees.action_from_parent, trees.node_done, trees.child_P,
                        path_cap=path_cap, c_puct_base=c_puct_base,
                        c_puct_init=c_puct_init))
            with trace.span("search.gather"):
                parent_states = _game_state_of(
                    _gather_state_rows(trees.states, parent), num_actions)
            with trace.span("go.step"):
                new_states = tree_engine.step_batch(parent_states, action)
            with trace.span("search.materialize"):
                trees, leaf, needs_eval = _materialize_scatter(
                    trees, slot, parent, action, child, hit_term, active,
                    _node_state_of(new_states), new_states.done, new_states.last_reward,
                    p_sel)
            with trace.span("search.history"):
                history = _leaf_history_batch(trees, parent, depth, new_states.board,
                                              num_stack)
            prior, value = eval_fn(engine.observation_from(history, new_states.to_play))
            with trace.span("search.expand_backup"):
                # Keep the -1 illegal sentinel in the stored prior (Tree.child_P).
                prior_sel = torch.where(new_states.legal > 0.5, prior, -1.0)
                _expand_backup_scatter(trees, slot, leaf, needs_eval, active, even, odd,
                                       depth, prior_sel, value)

    with trace.span("search.root_stats"):
        # Root child stats: each root child's N/W added at its action (one
        # node per action, so the sums are exact); other nodes go to a dump
        # column.
        at = torch.where(trees.parent_index == 0.0, trees.action_from_parent,
                         float(num_actions)).long()

        def by_action(x: torch.Tensor) -> torch.Tensor:
            out = torch.zeros((batch, num_actions + 1), device=x.device)
            return out.scatter_add_(1, at, x)[:, :num_actions]

        result = SearchResult(
            child_N=by_action(trees.node_N),
            child_W=by_action(trees.node_W),
            root_Q=trees.node_W[:, 0] / torch.clamp_min(trees.node_N[:, 0], 1.0),
            legal=trees.root_legal,
        )
    if return_trees:
        return result, trees
    return result


# ---------------------------------------------------------------------------
# Policy / move extraction
# ---------------------------------------------------------------------------


def _temp_exponent(temperature: float) -> float:
    """The reference's overflow-safe exponent clamp: clip(1/temp, 1, 5)."""
    if not 0.0 < temperature <= 1.0:
        raise ValueError(f"Expect temperature in (0.0, 1.0], got {temperature}")
    return max(1.0, min(5.0, 1.0 / temperature))


def policy_from_counts(child_N: torch.Tensor, legal: torch.Tensor,
                       warm_up: torch.Tensor, warm_up_temperature: float = 1.0,
                       temperature: float = 0.1) -> torch.Tensor:
    """Visit-count policy: ``warm_up_temperature`` while ``warm_up [B]``,
    ``temperature`` after, exponent = clip(1/temp, 1, 5)."""
    counts = child_N * legal
    exponent = torch.where(warm_up, _temp_exponent(warm_up_temperature),
                           _temp_exponent(temperature))[:, None]
    powered = counts ** exponent
    total = powered.sum(dim=-1, keepdim=True)
    return torch.where(total > 0, powered / torch.clamp_min(total, 1e-9), powered)


def gumbel_draw(generator: Optional[torch.Generator], shape, device) -> torch.Tensor:
    """Standard Gumbel noise, drawn as ``jax.random.gumbel`` draws it."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u * (1.0 - tiny) + tiny))


def sample_move(gumbel: Optional[torch.Tensor], search_pi: torch.Tensor,
                legal: torch.Tensor, child_N: torch.Tensor, warm_up: torch.Tensor,
                pass_move: Optional[int], deterministic: bool) -> torch.Tensor:
    """The move: argmax of visits when deterministic, else a sample from the
    search policy as ``argmax(log(probs) + gumbel)`` — what
    ``jax.random.categorical`` computes — excluding pass during warm-up
    (falling back to uniform over the remaining legal moves)."""
    if deterministic:
        return torch.argmax(child_N, dim=-1).to(torch.int32)

    probs = search_pi * legal
    fallback = legal.float()
    if pass_move is not None:
        ban_pass = warm_up[:, None] & (
            torch.arange(probs.shape[-1], device=probs.device) == pass_move)
        probs = torch.where(ban_pass, 0.0, probs)
        fallback = torch.where(
            ban_pass & (legal.sum(dim=-1, keepdim=True) > 1), 0.0, fallback)
    total = probs.sum(dim=-1, keepdim=True)
    probs = torch.where(total > 0, probs, fallback)
    logits = torch.log(torch.clamp_min(probs, 1e-30))
    return torch.argmax(gumbel + logits, dim=-1).to(torch.int32)


def best_child_q(child_N: torch.Tensor, child_W: torch.Tensor,
                 move: torch.Tensor) -> torch.Tensor:
    """-Q of the selected child, 0 when unvisited."""
    idx = move[:, None].long()
    n = child_N.gather(1, idx)[:, 0]
    w = child_W.gather(1, idx)[:, 0]
    return torch.where(n > 0, -(w / torch.clamp_min(n, 1.0)), 0.0)
