"""Faults planted in the rows a call returns, one clip's
{"pos", "alive", "track_id"} each: for the output check's own tests (a
run of the harness with the timed path broken underneath) and for the
readings that its limits are set from (calibrate.py, the faults planted
in the reference put in the program's place)."""

from __future__ import annotations

import numpy as np


def state_unchanged(outs: list) -> list:
    """Every row is the first: a step that returns its state as it was."""
    for o in outs:
        for k in o:
            o[k][1:] = o[k][:1]
    return outs


def half_left_out(outs: list) -> list:
    """Half of a batch's clips left out; of one clip, the positions of
    half of the track pool never moved."""
    if len(outs) > 1:
        return outs[:len(outs) // 2]
    for o in outs:
        half = o["pos"].shape[1] // 2
        o["pos"][1:, :half] = o["pos"][:1, :half]
    return outs


def half_pool_dead(outs: list) -> list:
    """The first half of the track pool's slots reported dead at every
    frame."""
    for o in outs:
        o["alive"][:, :o["alive"].shape[1] // 2] = False
    return outs


def killed_after_first(outs: list) -> list:
    """Every track reported dead after frame 0."""
    for o in outs:
        o["alive"][1:] = False
    return outs


def answer_altered(outs: list) -> list:
    """One live track's position moved by two pixels where it is
    produced."""
    o = outs[0]
    t, k = np.argwhere(o["alive"][1:])[0]
    o["pos"][t + 1, k, 0] += 2.0
    return outs


FAULTS = {f.__name__: f for f in (state_unchanged, half_left_out,
                                  half_pool_dead, killed_after_first,
                                  answer_altered)}


def plant(name: str, outs: list) -> list:
    """A broken copy of `outs`, the rows of a call's clips."""
    return FAULTS[name]([{k: np.array(v) for k, v in o.items()}
                         for o in outs])
