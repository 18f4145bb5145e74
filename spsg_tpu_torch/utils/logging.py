"""CSV + stdout training logs, format-compatible with the reference
(torch/train.py:214-396, consumed by plot.py).

A copy of ``spsg_tpu/utils/logging.py`` (numpy only), so that the port writes
``log.csv`` / ``log_val.csv`` byte for byte as the JAX package does without
importing it."""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional

import numpy as np

_SPLITTER = ","

LOSS_KEYS = [
    "loss",
    "loss_occ",
    "iou_occ",
    "loss_sdf",
    "loss_depth",
    "loss_color",
    "loss_semantic",
    "loss_disc",
    "loss_disc_real",
    "loss_disc_fake",
    "loss_gen",
    "loss_style",
    "loss_content",
]

_HEADER_NAMES = [
    "loss(total)",
    "loss(occ)",
    "iou(occ)",
    "loss(sdf)",
    "loss(depth)",
    "loss(color)",
    "loss(semantic)",
    "loss(disc)",
    "loss(disc-real)",
    "loss(disc-fake)",
    "loss(gen)",
    "loss(style)",
    "loss(content)",
]


def make_header(ids: List[str]) -> List[str]:
    headers = ["epoch", "iter"]
    for id_ in ids:
        headers.extend([f"{id_}_{h}" for h in _HEADER_NAMES])
        headers.append("time")
    return headers


class MetricsAccumulator:
    """Collects per-step metric dicts; means ignore missing entries and -1
    sentinels (reference print_log, train.py:286-396). Adversarial losses
    (disc/gen) are averaged without the >=0 filter, like the reference —
    wgan losses are legitimately negative (train.py:317-320)."""

    _UNFILTERED = ("loss_disc", "loss_disc_real", "loss_disc_fake", "loss_gen")

    def __init__(self):
        self._vals: Dict[str, List[float]] = {k: [] for k in LOSS_KEYS}

    def add(self, metrics: Dict) -> None:
        for k in LOSS_KEYS:
            if k in metrics:
                v = float(metrics[k])
                self._vals[k].append(v)

    def means(self) -> Dict[str, float]:
        out = {}
        for k, vals in self._vals.items():
            arr = np.asarray([v for v in vals if np.isfinite(v)])
            if k not in self._UNFILTERED and len(arr):
                arr = arr[arr >= 0]
            out[k] = float(arr.mean()) if len(arr) else -1.0
        return out

    def reset(self) -> None:
        for v in self._vals.values():
            v.clear()


class TrainLog:
    """CSV log files: log.csv (train) and log_val.csv (train+val), mirroring
    write_header/print_log (train.py:221-231)."""

    def __init__(self, save_dir: str, has_val: bool):
        os.makedirs(save_dir, exist_ok=True)
        self.train_file = open(os.path.join(save_dir, "log.csv"), "a")
        self.val_file = (
            open(os.path.join(save_dir, "log_val.csv"), "a") if has_val else None
        )
        if self.train_file.tell() == 0:
            self.train_file.write(_SPLITTER.join(make_header(["train"])) + "\n")
            self.train_file.flush()
        if self.val_file is not None and self.val_file.tell() == 0:
            header = make_header(["train"])[:-1] + [
                f"val_{h}" for h in _HEADER_NAMES
            ] + ["time"]
            self.val_file.write(_SPLITTER.join(header) + "\n")
            self.val_file.flush()

    def log_train(self, epoch: int, it: int, means: Dict[str, float], took: float) -> None:
        row = [epoch, it] + [means[k] for k in LOSS_KEYS] + [took]
        self.train_file.write(_SPLITTER.join(str(v) for v in row) + "\n")
        self.train_file.flush()
        pretty = " ".join(
            f"{name}: {means[k]:.6f}" for name, k in zip(_HEADER_NAMES, LOSS_KEYS)
        )
        print(f"Epoch: {epoch} iter: {it} {pretty} time: {took:.2f}", file=sys.stdout)

    def log_val(
        self, epoch: int, it: int, train_means: Dict[str, float],
        val_means: Dict[str, float], took: float,
    ) -> None:
        if self.val_file is None:
            return
        row = (
            [epoch, it]
            + [train_means[k] for k in LOSS_KEYS]
            + [val_means[k] for k in LOSS_KEYS]
            + [took]
        )
        self.val_file.write(_SPLITTER.join(str(v) for v in row) + "\n")
        self.val_file.flush()
        pretty = " ".join(
            f"val_{name}: {val_means[k]:.6f}" for name, k in zip(_HEADER_NAMES, LOSS_KEYS)
        )
        print(f"Epoch: {epoch} iter: {it} {pretty}", file=sys.stdout)

    def close(self):
        self.train_file.close()
        if self.val_file is not None:
            self.val_file.close()


def dump_args(args, output_file: str) -> None:
    """args.txt JSON dump (reference data_util.py:41-43)."""
    d = args.__dict__ if hasattr(args, "__dict__") else dict(args)
    with open(output_file, "w") as f:
        json.dump(d, f, indent=2, default=str)
