"""Game-result strings shared by the batched pipelines.

Matches the reference conventions: Go scores as ``B+2.5``/``W+0.5``
(``Position.result_string`` go_engine.py:527-534), resignations as
``B+R``/``W+R``, Gomoku wins as ``B+1.0``/``W+1.0`` (gomoku.py:138-147 —
Gomoku has no score, so the winner alone decides), ``DRAW`` otherwise.
"""

from __future__ import annotations


def result_string(winner: int, score: float, resigned: bool) -> str:
    if resigned:
        return "B+R" if winner == 1 else "W+R"
    if score > 0:
        return "B+%.1f" % score
    if score < 0:
        return "W+%.1f" % abs(score)
    if winner == 1:
        return "B+1.0"
    if winner == -1:
        return "W+1.0"
    return "DRAW"
