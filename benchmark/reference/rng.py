"""The per-path LCG stream: a 4-round tea hash seeds ``state = 16807 *
state + 1013904223 (mod 2^32)``; a draw is ``float32(state) * 2^-32``.
The state is carried as int64 holding a value below 2^32."""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def _mix(a, s: int, c_shl: int, c_shr: int):
    shl = (((a << 4) & MASK32) + c_shl) & MASK32
    shr = ((a >> 5) + c_shr) & MASK32
    return shl ^ ((a + s) & MASK32) ^ shr


def seed(u, v):
    """Tea hash of two integer tensors -> int64 LCG state."""
    su = u.to(torch.int64) & MASK32
    sv = v.to(torch.int64) & MASK32
    s = 0
    for _ in range(4):
        s = (s + 0x9E3779B9) & MASK32
        su = (su + _mix(sv, s, 0xA341316C, 0xC8013EA4)) & MASK32
        sv = (sv + _mix(su, s, 0xAD90777D, 0x7E95761E)) & MASK32
    return su


def draw(state):
    """One float and the advanced state."""
    s = (16807 * state + 1013904223) & MASK32
    return s.to(torch.float32) * 2.0**-32, s
