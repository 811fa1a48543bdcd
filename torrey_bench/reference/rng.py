"""Counter-based stateless RNG: PCG-RXS-M-XS 32/32 over int32 tensors.

Frozen from the PyTorch port's ``ops/rng.py``, bit-exact with
its uint32 functions (``seed_rays`` and ``next_uniform``).  One PCG state per
ray, seeded from ``(pixel_index, sample_index, seed)``, so every (pixel,
sample) pair has its own stream and no global random state exists.

torch has no uint32 ``add``/``mul`` on the CPU, so this follows the JAX
package's int32 twin: two's-complement multiply and add wrap exactly like
uint32 arithmetic modulo 2^32, XOR is bitwise, and a logical right shift is
an arithmetic shift followed by a mask of the low ``32 - k`` bits.  The
final 24-bit word is non-negative, so the int32 -> float32 cast is exact.
The CUDA megakernel (csrc/megakernel.cu) runs the same generator in native
uint32.
"""

from __future__ import annotations

import torch


def _as_i32(x: int) -> int:
    """uint32 value -> the int32 with the same bits, as a Python int."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


_MULT = _as_i32(747796405)
_INC = _as_i32(2891336453)
_PERM = _as_i32(277803737)
_GOLD = _as_i32(0x9E3779B9)
_MIX = _as_i32(0x85EBCA6B)


def _srl(x: torch.Tensor, k) -> torch.Tensor:
    """Logical right shift of int32 ``x`` by ``k`` in [1, 31] (an int or an
    int32 tensor): the arithmetic shift with the sign-extended bits masked
    off."""
    if isinstance(k, int):
        return (x >> k) & ((1 << (32 - k)) - 1)
    return (x >> k) & ((torch.ones_like(k) << (32 - k)) - 1)


def _pcg_permute(state: torch.Tensor) -> torch.Tensor:
    word = _srl(state, _srl(state, 28) + 4) ^ state
    word = word * _PERM
    return _srl(word, 22) ^ word


def seed_rays(pixel_index: torch.Tensor, sample_index,
              seed: int = 1984) -> torch.Tensor:
    """Per-ray int32 PCG states from pixel index, sample index and seed.
    ``sample_index`` is an int or an integer tensor; it wraps modulo 2^32
    like the JAX package's uint32 cast."""
    if isinstance(sample_index, int):
        mixed = _as_i32(sample_index * _MIX)
    else:
        mixed = sample_index.to(torch.int32) * _MIX
    s = (pixel_index.to(torch.int32) * _GOLD
         + mixed
         + _as_i32(seed))
    s = s * _MULT + _INC
    return _pcg_permute(s) * _MULT + _INC


def next_uniform(state: torch.Tensor):
    """Advance and draw one float32 uniform in [0, 1) per ray.
    Returns (new_state, u)."""
    state = state * _MULT + _INC
    word = _pcg_permute(state)
    u = _srl(word, 8).to(torch.float32) * (1.0 / (1 << 24))
    return state, u


def next_uniform2(state: torch.Tensor):
    state, u1 = next_uniform(state)
    state, u2 = next_uniform(state)
    return state, u1, u2
