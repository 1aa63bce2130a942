"""``correct`` on the CPU at a size a test run holds: true for the program,
false for the control (the reference one precision below the
configuration's in the program's place) and for every fault planted under
the timed path that the cell's judge sees. On a card, the control again at
the cells' own sizes."""

from __future__ import annotations

import time

import pytest

import control
import run as bench

OFFLINE = ("advoc.chunks-b128", "advoc.ljspeech-b8")


def once(cell: str, kind: str, device: str = "cpu", seconds: float = 1.0):
    return bench.execute(cell, 2**31 + 17, seconds, False, device, make=control.maker(kind),
                         t0=time.monotonic())


@pytest.mark.parametrize("cell", OFFLINE)
def test_offline_program_correct(tiny, cell):
    assert once(cell, "program")["correct"]


@pytest.mark.parametrize("kind", ("control",) + control.FAULTS)
def test_offline_control_and_faults_fail(tiny, kind):
    res = once(OFFLINE[0], kind)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", OFFLINE)
def test_control_fails_on_card(card, cell):
    assert not once(cell, "control", "cuda", seconds=2.0)["correct"]
