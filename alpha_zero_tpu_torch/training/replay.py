"""Host-RAM uniform replay over preallocated NumPy rings.

Functional parity with the reference (`alpha_zero/core/replay.py:35-116`):
circular buffer of (state, pi_prob, value) transitions, uniform sampling with
replacement, whole-state (de)serialization for resume, ``num_games_added`` /
``num_samples_added`` accounting.

TPU-native deltas: transitions arrive as *batches* from the device self-play
program (not one Python object at a time), so storage is three NumPy rings
written by slice — no per-item Python overhead, no compression needed
(int8 observations are already 4x smaller than the reference's float
states). The rings grow geometrically with actual fill up to ``capacity``
(see ``_ensure_alloc``) — the jumbo capacity is 50M samples / 286 GiB,
which must not be allocated up front.
"""

from __future__ import annotations

import os
from typing import Any, Mapping, NamedTuple, Optional, Tuple

import numpy as np


class Transition(NamedTuple):
    state: Any      # [N, N, C] int8 observation (NHWC)
    pi_prob: Any    # [A] float32 search policy
    value: Any      # float32 z-target


class UniformReplay:
    """Uniform random sampling with replacement from a circular buffer."""

    # Rings grow geometrically toward ``capacity`` instead of being
    # preallocated: the jumbo config's 50M-sample capacity would otherwise
    # eagerly allocate 286 GiB of host RAM at construction (the reference's
    # buffer is a Python list that also grows with actual fill,
    # replay.py:35-59). Until the first wrap, writes are sequential, so the
    # high-water mark is simply min(num_samples_added, capacity).
    _GROW_CHUNK = 1 << 16

    def __init__(self, capacity: int, obs_shape: Tuple[int, ...], num_actions: int,
                 seed: int = 0) -> None:
        if capacity <= 0:
            raise ValueError(f"Expect capacity to be a positive integer, got {capacity}")
        self.capacity = capacity
        alloc = min(capacity, self._GROW_CHUNK)
        self.states = np.zeros((alloc,) + tuple(obs_shape), np.int8)
        self.pi_probs = np.zeros((alloc, num_actions), np.float32)
        self.values = np.zeros((alloc,), np.float32)
        self.random_state = np.random.RandomState(seed)
        self.num_games_added = 0
        self.num_samples_added = 0

    @property
    def _alloc(self) -> int:
        return len(self.values)

    def _ensure_alloc(self, rows: int) -> None:
        if rows <= self._alloc:
            return
        new_alloc = min(self.capacity, max(rows, 2 * self._alloc))

        def grow(arr):
            out = np.zeros((new_alloc,) + arr.shape[1:], arr.dtype)
            out[: len(arr)] = arr
            return out

        self.states = grow(self.states)
        self.pi_probs = grow(self.pi_probs)
        self.values = grow(self.values)

    # -- writes -------------------------------------------------------------
    def add_game(self, states: np.ndarray, pi_probs: np.ndarray, values: np.ndarray) -> None:
        """Adds one finished game's transitions (arrays stacked over moves)."""
        self.add_batch(states, pi_probs, values)
        self.num_games_added += 1

    def add_batch(self, states: np.ndarray, pi_probs: np.ndarray, values: np.ndarray) -> None:
        n = len(values)
        if n == 0:
            return
        start = self.num_samples_added % self.capacity
        end = start + n
        self._ensure_alloc(min(self.capacity, end))
        if end <= self.capacity:
            self.states[start:end] = states
            self.pi_probs[start:end] = pi_probs
            self.values[start:end] = values
        else:
            first = self.capacity - start
            self.states[start:] = states[:first]
            self.pi_probs[start:] = pi_probs[:first]
            self.values[start:] = values[:first]
            rest = end - self.capacity
            self.states[:rest] = states[first:]
            self.pi_probs[:rest] = pi_probs[first:]
            self.values[:rest] = values[first:]
        self.num_samples_added += n

    # -- reads --------------------------------------------------------------
    def sample(self, batch_size: int) -> Optional[Transition]:
        """Uniform with replacement; None until ``batch_size`` items exist
        (replay.py:73-83)."""
        if self.size < batch_size:
            return None
        indices = self.random_state.randint(0, self.size, size=batch_size)
        return Transition(
            state=self.states[indices],
            pi_prob=self.pi_probs[indices],
            value=self.values[indices],
        )

    @property
    def size(self) -> int:
        return min(self.num_samples_added, self.capacity)

    # -- (de)serialization ---------------------------------------------------
    def get_state(self) -> Mapping[str, Any]:
        return {
            "num_games_added": self.num_games_added,
            "num_samples_added": self.num_samples_added,
            "states": self.states,
            "pi_probs": self.pi_probs,
            "values": self.values,
        }

    def set_state(self, state: Mapping[str, Any]) -> None:
        self.num_games_added = state["num_games_added"]
        self.num_samples_added = state["num_samples_added"]
        self.states = state["states"]
        self.pi_probs = state["pi_probs"]
        self.values = state["values"]

    def save(self, path: str) -> None:
        # Atomic: a crash/kill mid-write must never corrupt the previous
        # snapshot (a truncated npz crash-loops every supervisor resume).
        tmp = path + ".tmp.npz"
        np.savez_compressed(
            tmp,
            num_games_added=self.num_games_added,
            num_samples_added=self.num_samples_added,
            states=self.states,
            pi_probs=self.pi_probs,
            values=self.values,
        )
        os.replace(tmp, path)

    def load(self, path: str) -> None:
        data = np.load(path)
        self.set_state({
            "num_games_added": int(data["num_games_added"]),
            "num_samples_added": int(data["num_samples_added"]),
            "states": data["states"],
            "pi_probs": data["pi_probs"],
            "values": data["values"],
        })
