"""Minimal SGF (Smart Game Format) read/write — host-side I/O only.

Serialization mirrors the reference template (`alpha_zero/utils/sgf_wrapper.py:38-91`)
so emitted game records are drop-in compatible. Parsing is a small self-contained
recursive-descent reader (the reference depends on the external ``sgf`` package,
which we avoid): it extracts root properties and the main-line move sequence,
which is everything the evaluation dataset builder (`core/eval_dataset.py`) needs.
"""

from __future__ import annotations

import itertools
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from alpha_zero_tpu_torch.utils.coords import CoordsConvertor

SGF_TEMPLATE = """(;\nCA[UTF-8]\nAP[AlphaZeroTPU_sgfgenerator]\nRU[{ruleset}]
PB[{black_name}]\nBR[{black_rank}]\nPW[{white_name}]\nWR[{white_rank}]
KM[{komi}]\nRE[{result}]\nDT[{date}]\nSZ[{boardsize}]\n
{game_moves})"""


def translate_sgf_move(cc: CoordsConvertor, color: str, flat_move: int, comment: Optional[str] = None) -> str:
    """One move node, e.g. ``;B[dd]``; ``color`` is 'B' or 'W'."""
    if color not in ("B", "W"):
        raise ValueError(f"Can't translate color {color} to sgf")
    comment_node = ""
    if comment is not None:
        comment_node = "C[{}]".format(comment.replace("]", r"\]"))
    return ";{color}[{coords}]{comment_node}".format(
        color=color,
        coords=cc.to_sgf(cc.from_flat(flat_move)),
        comment_node=comment_node,
    )


def make_sgf(
    board_size: int,
    move_history: Iterable,  # iterable of (color, flat_move) pairs (PlayerMove-like)
    result_string: str,
    ruleset: str = "Chinese",
    komi=7.5,
    white_name: str = "AlphaZeroTPU",
    white_rank: str = "",
    black_name: str = "AlphaZeroTPU",
    black_rank: str = "",
    date: str = "",
    comments: Iterable[Optional[str]] = (),
) -> str:
    """Serialize a finished game to SGF (no handicap support, full history)."""
    cc = CoordsConvertor(board_size)
    game_moves = [
        translate_sgf_move(cc, move.color, move.move, comment)
        for move, comment in itertools.zip_longest(move_history, comments)
    ]
    # Newline after every 10th move node for readability.
    game_moves = [m + "\n" if (i + 1) % 10 == 0 else m for i, m in enumerate(game_moves)]
    return SGF_TEMPLATE.format(
        ruleset=ruleset,
        black_name=black_name,
        black_rank=black_rank,
        white_name=white_name,
        white_rank=white_rank,
        komi=komi,
        result=result_string,
        date=date,
        boardsize=board_size,
        game_moves="".join(game_moves),
    )


def parse_game_result(result: Optional[str]) -> int:
    """SGF result string -> winner color: +1 black, -1 white, 0 neither."""
    if result is None:
        return 0
    if re.match(r"[bB]\+", result):
        return 1
    if re.match(r"[wW]\+", result):
        return -1
    return 0


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


@dataclass
class SgfGame:
    """Root properties + main-line moves of one SGF game tree."""

    props: Dict[str, List[str]] = field(default_factory=dict)
    # (color, sgf_coord) pairs, color in {'B','W'}; coord '' means pass.
    moves: List[Tuple[str, str]] = field(default_factory=list)

    def prop(self, key: str) -> Optional[str]:
        vals = self.props.get(key)
        if not vals:
            return None
        return vals[0]

    @property
    def board_size(self) -> Optional[int]:
        sz = self.prop("SZ")
        return int(sz) if sz else None

    @property
    def result(self) -> Optional[str]:
        return self.prop("RE")

    @property
    def komi(self) -> Optional[float]:
        km = self.prop("KM")
        try:
            return float(km) if km not in (None, "") else None
        except ValueError:
            return None


class _Scanner:
    def __init__(self, text: str) -> None:
        self.text = text
        self.pos = 0

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def next(self) -> str:
        ch = self.peek()
        self.pos += 1
        return ch

    def skip_ws(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos].isspace():
            self.pos += 1


_PROP_IDENT = re.compile(r"[A-Za-z]+")


def _parse_prop_value(sc: _Scanner) -> str:
    """Parses one ``[...]`` value; handles ``\\]`` escapes."""
    assert sc.next() == "["
    out = []
    while True:
        ch = sc.next()
        if ch == "":
            break
        if ch == "\\":
            out.append(sc.next())
            continue
        if ch == "]":
            break
        out.append(ch)
    return "".join(out)


def parse_sgf(text: str) -> SgfGame:
    """Parses the first game tree of an SGF collection (main line only).

    Variations are skipped: only the first child branch at each fork is
    followed, matching how the reference's dataset builder walks game records.
    """
    game = SgfGame()
    sc = _Scanner(text)
    sc.skip_ws()
    if sc.peek() != "(":
        raise ValueError("not an SGF game tree")
    sc.next()

    depth = 1
    first_node = True
    in_main_line = True
    while sc.pos < len(sc.text):
        sc.skip_ws()
        ch = sc.peek()
        if ch == "":
            break
        if ch == "(":
            sc.next()
            depth += 1
            # only the first subtree continues the main line
            if depth > 2:
                in_main_line = False
            continue
        if ch == ")":
            sc.next()
            depth -= 1
            if depth <= 0:
                break
            # after closing a subtree, everything else at this level is a variation
            in_main_line = False
            continue
        if ch == ";":
            sc.next()
            continue
        m = _PROP_IDENT.match(sc.text, sc.pos)
        if m is None:
            sc.next()
            continue
        ident = m.group(0).upper()
        sc.pos = m.end()
        values = []
        sc.skip_ws()
        while sc.peek() == "[":
            values.append(_parse_prop_value(sc))
            sc.skip_ws()
        if not in_main_line:
            continue
        if ident in ("B", "W"):
            game.moves.append((ident, values[0] if values else ""))
        elif first_node or ident not in game.props:
            game.props.setdefault(ident, []).extend(values)
        if ident not in ("B", "W") and first_node:
            pass
        first_node = False
    return game
