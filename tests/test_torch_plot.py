"""Parity of the port's ``cli/plot.py`` with the JAX package's: the frames
``load_logs`` reads from the in-repo logs equal, and a dashboard PNG
written from each logs directory."""

import os

import pandas as pd
import pytest

from alpha_zero_tpu.cli import plot as jax_plot
from alpha_zero_tpu_torch.cli import plot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOGS = ["logs/go/9x9", "logs/go/19x19_e2e"]


@pytest.mark.parametrize("logs", LOGS)
def test_load_logs_like_jax(logs):
    ref = jax_plot.load_logs(os.path.join(REPO, logs))
    out = plot.load_logs(os.path.join(REPO, logs))
    assert ref[0] is not None and len(ref[0]) > 0
    for r, o in zip(ref, out):
        if r is None:
            assert o is None
        else:
            pd.testing.assert_frame_equal(r, o)


@pytest.mark.parametrize("logs", LOGS)
def test_dashboard_png(tmp_path, capsys, logs):
    out_file = tmp_path / "dashboard.png"
    plot.main(["--logs_dir", os.path.join(REPO, logs), "--out", str(out_file)])
    assert capsys.readouterr().out == f"dashboard written to {out_file}\n"
    assert out_file.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert out_file.stat().st_size > 10_000
