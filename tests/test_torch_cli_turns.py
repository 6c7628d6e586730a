"""cli_turns: the CLI from two trees in turns, old, new, new, old."""

import json
from pathlib import Path

from ising_tpu_torch import cli_turns

ROOT = str(Path(__file__).resolve().parents[1])
ARGS = ["--backend", "mxu", "-x", "256", "-y", "128", "-n", "2", "-p", "1",
        "--device", "cpu"]


def test_runs_both_trees_in_turns(capsys):
    assert cli_turns.main([ROOT, ROOT, "--", *ARGS]) == 0
    out = capsys.readouterr().out.splitlines()
    assert sum("flips/ns" in ln and ln.startswith("[turns]") for ln in out) == 4
    runs = json.loads(out[-1])["runs"]
    assert [tree for tree, _ in runs] == [ROOT] * 4
    assert all(isinstance(rate, float) and rate >= 0 for _, rate in runs)


def test_needs_two_trees_and_the_separator(capsys):
    assert cli_turns.main([ROOT, "--backend", "mxu"]) == 2
    assert "OLD_TREE NEW_TREE" in capsys.readouterr().out
