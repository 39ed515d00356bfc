"""The per-lane LCG stream (counterpart of ``owl_path_tracer_tpu/ops/rng.py``).

A 4-round tea-style seed hash followed by ``state = 16807 * state +
1013904223 (mod 2^32)``, floats as ``float(state) * 2^-32``.

PyTorch has no uint32 add or shift on the CPU, so the state is carried as
int64 holding a value in [0, 2^32), masked with ``0xFFFFFFFF`` after every
add, multiply and shift.  Every value fits int64 without overflow
(16807 * (2^32 - 1) < 2^47), so the stream is bit-equal to the uint32 one.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_A = 16807
_C = 1013904223
_TEA_ROUNDS = 4
_LDEXP_M32 = 2.0**-32


def _tea_mix(a, s: int, c_shl: int, c_shr: int):
    """((a << 4) + c_shl) ^ (a + s) ^ ((a >> 5) + c_shr), each term mod 2^32."""
    shl = (((a << 4) & MASK32) + c_shl) & MASK32
    shr = ((a >> 5) + c_shr) & MASK32
    return shl ^ ((a + s) & MASK32) ^ shr


def seed(u, v):
    """Tea hash of two integer tensors -> int64 LCG state of the same shape."""
    su = u.to(torch.int64) & MASK32
    sv = v.to(torch.int64) & MASK32
    s = 0
    for _ in range(_TEA_ROUNDS):
        s = (s + 0x9E3779B9) & MASK32
        su = (su + _tea_mix(sv, s, 0xA341316C, 0xC8013EA4)) & MASK32
        sv = (sv + _tea_mix(su, s, 0xAD90777D, 0x7E95761E)) & MASK32
    return su


def next_state(state):
    """One LCG step: A*state + C (mod 2^32)."""
    return (_A * state + _C) & MASK32


def to_float(state):
    """float32(state) * 2^-32, uniform in [0, 1]."""
    return state.to(torch.float32) * _LDEXP_M32


def next_f32(state):
    """Draw one float; returns (value, new_state)."""
    s = next_state(state)
    return to_float(s), s


def next_f32_n(state, n: int):
    """Draw ``n`` sequential floats -> (values [n,...], states [n,...]);
    ``states[i]`` is the state after draw i."""
    vals, states = [], []
    s = state
    for _ in range(n):
        v, s = next_f32(s)
        vals.append(v)
        states.append(s)
    return torch.stack(vals), torch.stack(states)
