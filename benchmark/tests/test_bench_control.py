"""On the card, at a size a test run holds: the program passes the cell's
limits and the control (the reference in TF32, in the program's place) fails
at least one of them, as the readings at the cells' own sizes showed
(``tools/readings.py``; PERF.md lists them)."""

import json
import os

import pytest
import torch
from conftest import BENCH


def _limits(cell):
    with open(os.path.join(BENCH, "limits", cell + ".json")) as f:
        return json.load(f)


def _driver(name):
    import sys

    return sys.modules[name]


@pytest.mark.card
@pytest.mark.parametrize("seed", [11, 12])
def test_training_control_fails_and_the_program_passes(card, seed):
    import run

    d = _driver("drivers_train")
    bench = run.load_json(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"))
    _, config, traffic, _ = run.cell_files(bench, "train-full-b2")
    config = run._merged(config, {"train": {"input_dim": [64, 32, 32]}})
    weights = d.load_weights(os.path.join(BENCH, config["weights"]))
    pool = d.make_pool(config, traffic, seed, card, count=d.FIRST_STEPS)
    prog = d.program_snapshot(d.Program(config, weights, seed, card), pool)
    ref = d.reference_snapshot(config, weights, pool, card)
    ctl = d.reference_snapshot(config, weights, pool, card, tf32=True)
    lim = _limits("train-full-b2")
    assert all(v <= lim[k] for k, v in d.compare(prog, ref).items())
    assert any(v > lim[k] for k, v in d.compare(ctl, ref).items())


@pytest.mark.card
@pytest.mark.parametrize("seed", [11, 12])
def test_serving_control_fails_and_the_program_passes(card, seed):
    import run

    d = _driver("drivers_serve")
    bench = run.load_json(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json"))
    _, config, traffic, _ = run.cell_files(bench, "serve-chunked")
    config = run._merged(config, {"serve": {"chunk_dims": [64, 64, 64], "max_height": 64}})
    traffic = run._merged(traffic, {"rooms": [[64, 130, 164]], "pool_per_size": 2,
                                    "check_rooms": 2})
    state_dict = d.load_generator_state(os.path.join(BENCH, config["weights"]))
    prog = d.Program(config, state_dict, card)
    pairs, ctl = [], []
    for i in d.check_rooms(traffic, seed):
        room = d.make_room(traffic, seed, i, card)
        ref = d.reference_outputs(config, state_dict, room, card)
        pairs.append((prog.serve(room), ref))
        ctl.append((d.reference_outputs(config, state_dict, room, card, tf32=True), ref))
    lim = _limits("serve-chunked")
    assert all(v <= lim[k] for k, v in d.compare(pairs).items())
    assert any(v > lim[k] for k, v in d.compare(ctl).items())
    torch.cuda.empty_cache()
