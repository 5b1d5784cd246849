"""The checked-in examples must keep running (API-rot guard).

Each example supports ``--small`` and self-checks its own semantics
(generate verifies decode against the full forward on CPU;
serve_continuous asserts every queued request completes; train asserts
the loss decreases).
"""

import os
import runpy
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = [
    ("generate.py", ["--small"]),
    ("serve_continuous.py", ["--small"]),
    ("serve_paged.py", ["--small"]),
    ("train_seq_parallel.py", ["--small"]),
    ("train_sparse_transformer.py", ["--small", "--steps", "3"]),
    ("dynamic_sparse_training.py", ["--small"]),
    ("serve_speculative.py", ["--small"]),
    ("train_moe_transformer.py", ["--small", "--steps", "4"]),
    ("train_block_sparse.py", ["--small"]),
]


@pytest.mark.parametrize("name,args", EXAMPLES)
def test_example_runs_small(name, args, monkeypatch):
    path = os.path.join(_ROOT, "examples", name)
    monkeypatch.setattr(sys, "argv", [name] + args)
    runpy.run_path(path, run_name="__main__")
