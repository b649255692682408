"""Shared CLI helpers: config resolution with dotted-path overrides.

The port of ``alpha_zero_tpu.cli.common`` over the port's ``config``
(PyTorch has no compilation cache to set up).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Any, List

from alpha_zero_tpu_torch import config as config_lib


def _is_optional_field(cls: type, name: str) -> bool:
    """True when the dataclass field's annotation is Optional[...]."""
    import typing

    try:
        hints = typing.get_type_hints(cls)
    except Exception:  # noqa: BLE001 - unresolvable hints: treat as required
        return False
    t = hints.get(name)
    return (t is not None and typing.get_origin(t) is typing.Union
            and type(None) in typing.get_args(t))


def apply_override(cfg: Any, dotted: str, raw: str) -> Any:
    """Returns a copy of ``cfg`` with ``a.b.c=value`` applied (typed by the
    dataclass field's current value)."""
    parts = dotted.split(".")
    if len(parts) == 1:
        current = getattr(cfg, parts[0])
        optional = _is_optional_field(type(cfg), parts[0])
        return dataclasses.replace(
            cfg, **{parts[0]: _coerce(raw, current, optional, dotted)})
    sub = getattr(cfg, parts[0])
    new_sub = apply_override(sub, ".".join(parts[1:]), raw)
    return dataclasses.replace(cfg, **{parts[0]: new_sub})


def _coerce(raw: str, current: Any, optional: bool = False,
            name: str = "?") -> Any:
    if isinstance(current, bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if raw == "" and isinstance(current, (int, float)):
        # Null out an Optional numeric field (e.g. search.max_new_sims= for
        # the uncapped reference budget when the config default is an int).
        # Required numerics reject the empty string — a typo like
        # `--set train.batch_size=` must fail here, not deep in the run.
        if optional:
            return None
        raise ValueError(
            f"empty value for required numeric field '{name}' "
            f"(current: {current!r})")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        elems = [s for s in raw.strip("[]()").split(",") if s]
        elem_type = type(current[0]) if current else int
        return tuple(elem_type(e) for e in elems)
    if current is None:
        try:
            return int(raw)
        except ValueError:
            return raw
    return raw


def resolve_config(name: str, overrides: List[str]) -> config_lib.AlphaZeroConfig:
    cfg = config_lib.get_config(name)
    for ov in overrides or []:
        if "=" not in ov:
            raise ValueError(f"override '{ov}' must look like a.b.c=value")
        dotted, raw = ov.split("=", 1)
        cfg = apply_override(cfg, dotted, raw)
    return cfg


def add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--config", default="go9",
                        choices=sorted(config_lib.CONFIGS),
                        help="named base config")
    parser.add_argument("--set", action="append", default=[], metavar="a.b=v",
                        help="dotted-path config override (repeatable), e.g. "
                             "--set train.batch_size=256 --set env.board_size=9")
