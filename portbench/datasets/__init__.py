"""The program's side of each dataset a training cell names, one file per
dataset (``<dataset>.py``, as a cell's ``params["dataset"]`` names it),
each with ``make(root, p, cfg, seed, device)``: it writes the dataset's
seeded tree under `root` and returns (the program's dataset over it, the
files the reference reads back). Its reference side is
``reference/datasets/<dataset>.py``. Found by name, so a dataset of a later
cell adds its two files and edits none."""

from __future__ import annotations

import importlib


def module(name: str):
    return importlib.import_module(f"portbench.datasets.{name}")
