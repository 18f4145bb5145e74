"""The port's training logs (spsg_tpu_torch/utils/logging.py, a copy of the
JAX package's) against spsg_tpu.utils.logging on the same calls: the means
(the -1 sentinel, NaN and the negative adversarial losses), the header, and
log.csv / log_val.csv / args.txt byte for byte; and the phase timer."""

import argparse
import math

import numpy as np
import pytest

from spsg_tpu.utils import logging as J
from spsg_tpu_torch.utils import logging as P
from spsg_tpu_torch.utils.timing import PhaseTimer, torch_trace

ROWS = {
    "plain": [{"loss": 1.0, "loss_occ": 0.5, "iou_occ": 0.25}, {"loss": 3.0, "loss_occ": 0.75}],
    "sentinels": [{"loss": 1.0, "loss_sdf": -1.0, "loss_depth": -1.0},
                  {"loss": 2.0, "loss_sdf": 0.5}],
    "nan": [{"loss": float("nan"), "loss_color": 0.2}, {"loss": 4.0, "loss_color": float("nan")}],
    "negative_adversarial": [{"loss_disc": -0.5, "loss_gen": -2.0, "loss_disc_real": -1.5},
                             {"loss_disc": 0.5, "loss_gen": 2.0, "loss_disc_fake": -0.25}],
    "float32_values": [{k: np.float32(v) for k, v in zip(P.LOSS_KEYS, np.linspace(0.1, 1.3, 13))}],
}


@pytest.mark.parametrize("case", list(ROWS))
def test_means_match_the_jax_package(case):
    a, b = J.MetricsAccumulator(), P.MetricsAccumulator()
    for row in ROWS[case]:
        a.add(row)
        b.add(row)
    ma, mb = a.means(), b.means()
    assert list(ma) == list(mb) == P.LOSS_KEYS
    for k in ma:
        assert ma[k] == mb[k] or (math.isnan(ma[k]) and math.isnan(mb[k])), k
    b.reset()
    assert all(v == -1.0 for v in b.means().values())


def test_header_matches_the_jax_package():
    assert P.LOSS_KEYS == J.LOSS_KEYS
    assert P.make_header(["train"]) == J.make_header(["train"])
    assert P.make_header(["train", "val"]) == J.make_header(["train", "val"])


def test_log_files_are_the_same_bytes(tmp_path, capsys):
    runs = {}
    for name, mod in (("jax", J), ("port", P)):
        log = mod.TrainLog(str(tmp_path / name), has_val=True)
        for it, rows in enumerate(ROWS.values()):
            acc = mod.MetricsAccumulator()
            for row in rows:
                acc.add(row)
            log.log_train(it // 2, 20 * (it + 1), acc.means(), 1.5 * it)
            log.log_val(it // 2, 20 * (it + 1), acc.means(), acc.means(), 2.25 * it)
        log.close()
        runs[name] = capsys.readouterr().out
        # a second log in the same folder appends without a second header
        mod.TrainLog(str(tmp_path / name), has_val=True).close()
    assert runs["jax"] == runs["port"]
    for f in ("log.csv", "log_val.csv"):
        a = (tmp_path / "jax" / f).read_bytes()
        assert a == (tmp_path / "port" / f).read_bytes()
        assert a.count(b"\n") == 1 + len(ROWS)


def test_dump_args_is_the_same_bytes(tmp_path):
    args = argparse.Namespace(save="./logs", lr=1e-4, input_dim=0, device="cuda",
                              no_vis=False, compute_dtype="")
    J.dump_args(args, str(tmp_path / "a.txt"))
    P.dump_args(args, str(tmp_path / "b.txt"))
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt").read_bytes()


def test_phase_timer_keeps_its_history_and_reports():
    timer = PhaseTimer(report_every=2)
    lines = []
    for i in range(4):
        with timer.phase("setup"):
            pass
        if i % 2:
            with timer.phase("step"):
                pass
        timer.step(log_fn=lines.append)
    assert [sorted(h) for h in timer.history] == [["setup"], ["setup", "step"]] * 2
    assert timer.history.maxlen == PhaseTimer.HISTORY  # bounded for long runs
    assert len(lines) == 2 and lines[0].startswith("Average timings: setup: ")
    with torch_trace(None):  # no folder: no trace
        pass
