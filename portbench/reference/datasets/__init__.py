"""The reference's side of each dataset a cell names, one file per dataset
(``<dataset>.py``, as a cell's ``params["dataset"]`` names it), each with
``batch(files, picks, p, cfg, device)``: the (x, y) NCHW float32 batches in
[0, 1] on `device` that the samples `picks` [(dataset index, its
augmentation stream)] make, worked out again from the raw files the
harness wrote (`files`). Found by name, so a dataset of a later cell adds
its file and edits none."""

from __future__ import annotations

import importlib


def module(name: str):
    return importlib.import_module(f"portbench.reference.datasets.{name}")
