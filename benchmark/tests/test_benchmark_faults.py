"""``correct`` on the CPU at small sizes: a sound run is correct; the
control (the reference in TF32 in the program's place) and every fault a
cell can have, planted in the program underneath a run, are not. The
harness's look for a card is skipped; the rest of a run is driven as on the
card."""

import zlib

import pytest
import torch

from benchmark import run
from benchmark.harness import faults

CELLS = ["contconv-train-100k", "gnn-rollout-1m", "contconv-rollout-100k", "gnn-train-1m"]


def _kind(wl):
    return "train" if "train" in wl else "rollout"


def _run(wl, small, name, control=False, device=torch.device("cpu")):
    # a seed of each test's own, so that tests in parallel share no data file
    seed = 2 ** 31 + zlib.crc32(name.encode())
    res, numbers = run.run_cell(wl, seed, 0.2, False, device, 0.0,
                                control=control, traffic_overrides=small[_kind(wl)])
    return res, {n: (v, lim) for n, v, lim in numbers}


@pytest.mark.parametrize("wl", CELLS)
def test_a_sound_run_is_correct(wl, small, request):
    res, numbers = _run(wl, small, request.node.name)
    assert res["correct"], numbers
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("wl", CELLS)
def test_the_control_is_not_correct(wl, small, request):
    res, numbers = _run(wl, small, request.node.name, control=True)
    assert not res["correct"], numbers


@pytest.mark.gpu
@pytest.mark.parametrize("wl", CELLS)
def test_on_the_card_a_sound_run_is_correct_and_the_control_is_not(wl, small, cuda, request):
    res, numbers = _run(wl, small, request.node.name, device=cuda)
    assert res["correct"], numbers
    res, numbers = _run(wl, small, request.node.name, control=True, device=cuda)
    assert not res["correct"], numbers


FAULTS = [(wl, f) for wl in CELLS for f in faults.KINDS[_kind(wl)]]


@pytest.mark.parametrize("wl,fault", FAULTS, ids=[f"{w}-{f}" for w, f in FAULTS])
def test_a_planted_fault_is_not_correct(wl, fault, small, request):
    with faults.plant(fault):
        res, numbers = _run(wl, small, request.node.name)
    assert not res["correct"], numbers


TRAIN_FAULTS = [(wl, f) for wl in CELLS if _kind(wl) == "train" for f in faults.KINDS["train"]]


@pytest.mark.parametrize("wl,fault", TRAIN_FAULTS, ids=[f"{w}-{f}" for w, f in TRAIN_FAULTS])
def test_a_fault_in_the_window_alone_is_not_correct(wl, fault, small, request, monkeypatch):
    # a program that goes wrong only after its set-up epoch
    from benchmark.drivers import train

    orig = train.window

    def window(*args):
        with faults.plant(fault):
            return orig(*args)

    monkeypatch.setattr(train, "window", window)
    res, numbers = _run(wl, small, request.node.name)
    assert not res["correct"], numbers
    assert all(v <= lim for n, (v, lim) in numbers.items() if not n.startswith("window_"))
