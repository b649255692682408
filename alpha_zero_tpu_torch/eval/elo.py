"""Elo rating with USCF K-factor bands.

A copy of ``alpha_zero_tpu.eval.elo`` (framework-free; the port keeps its
own copy rather than import the JAX package).
"""

from __future__ import annotations

import math
from typing import Iterable


def get_k_factor(player_ratings: Iterable[float]) -> int:
    """USCF K-factor: 32 below 2100, 24 in [2100, 2400), 16 at/above 2400.

    Mixed bands fall back per the same rules as the reference: 24 when the
    higher-rated player is in [2100, 2400), else the default 32.
    """
    ratings = list(player_ratings)
    if all(r < 2100 for r in ratings):
        return 32
    if all(r < 2400 for r in ratings) and any(r >= 2100 for r in ratings):
        return 24
    if all(r >= 2400 for r in ratings):
        return 16
    return 32


class EloRating:
    """Standard expected-score Elo update."""

    def __init__(self, rating: float = 0) -> None:
        self.rating = rating

    def expected_score(self, opponent_rating: float) -> float:
        return 1 / (1 + math.pow(10, (opponent_rating - self.rating) / 400))

    def update_rating(self, opponent_rating: float, actual_score: float) -> None:
        expected = self.expected_score(opponent_rating)
        k = get_k_factor((self.rating, opponent_rating))
        self.rating += k * (actual_score - expected)
