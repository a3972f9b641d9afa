"""JAX's default PRNG, threefry-2x32 in its partitionable form
(``jax_threefry_partitionable``, the default since jax 0.5), so that the
port draws the numbers the JAX package draws from the same key.

A key is a (..., 2) ``torch.uint32`` tensor of the two 32-bit words of
``jax.random.key_data`` (``PRNGKey(seed)``: the seed's high and low
words); leading axes are lanes, one key each.  The plain versions
(`threefry2x32`, `split_plain`, `random_bits`, `uniform`,
`keep_mask_plain`) follow ``jax/_src/prng.py`` (``_threefry2x32_lowering``,
``_threefry_split_foldlike``, ``_threefry_random_bits_partitionable``)
and ``jax/_src/random.py`` (``_uniform``).  torch has no uint32
arithmetic on the CPU, so they compute in int64 masked to 32 bits (every
value stays below 2^32, so a right shift is logical).

Two hand-written CUDA kernels (``csrc/threefry.cu``) compute what the
frame program draws on the card, as one launch each: `split` (a key's
``jax.random.split``: the state's key once a step, a racing group's key
into one a lane, and every ICP pass's carry key, as
``loam_livox_tpu/registration/icp.py:235`` splits it) and `keep_mask`
(``loam_livox_tpu/ops/masked.py:73-84``'s ``random_keep_mask`` drawn
from a key: the bits, the uniform, the mask's count and the keep test).
No Pallas kernel stood here: XLA compiles the JAX package's threefry.
A CUDA tensor launches the kernel; a CPU tensor runs the plain version.
Every draw is a pure function of tensors, so a CUDA graph that replays
a pass draws new numbers each pass from the key its carry holds.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

M32 = 0xFFFFFFFF
#: the rotations of the 2x32 block's two alternating round groups
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
#: bits of a float32 1.0 and the 23 mantissa bits a uniform takes
ONE_BITS, MANTISSA_SHIFT = 0x3F800000, 9

#: launches of the split and keep-mask kernels made from Python since the
#: last reset (a call recorded into a CUDA graph launches nothing)
split_launches = 0
mask_launches = 0
#: each kernel's runs on the card, counted by the kernel (replays included)
split_runs = build.RunCounter()
mask_runs = build.RunCounter()
#: the most lanes of one launch (gridDim.y of the keep mask)
MAX_LANES = 65535


def prng_key(seed: int = 0, device=None) -> torch.Tensor:
    """``jax.random.key_data(jax.random.PRNGKey(seed))``: the (2,) uint32
    words of a 64-bit seed, high word first."""
    seed &= (1 << 64) - 1
    return torch.tensor([seed >> 32, seed & M32], dtype=torch.int64,
                        device=device).to(torch.uint32)


def _words(key: torch.Tensor):
    """A key's two words as int64, with a trailing axis to broadcast
    against a row of counters."""
    k = key.to(torch.int64)
    return k[..., 0:1], k[..., 1:2]


def threefry2x32(k0, k1, x0, x1):
    """The threefry-2x32 block (20 rounds) of the key words ``(k0, k1)``
    over the counter words ``(x0, x1)``; int64 tensors holding uint32
    values, broadcast together.  Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _counters(n: int, device):
    """The high and low words of the 64-bit iota 0 .. n-1."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & M32


def split_plain(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of each lane's key: (..., 2) ->
    (..., num, 2) uint32."""
    k0, k1 = _words(key)
    hi, lo = _counters(num, key.device)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return torch.stack([b0, b1], dim=-1).to(torch.uint32)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32 bits) of each lane's key:
    (..., 2) -> (..., *shape), as int64 values below 2^32."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    k0, k1 = _words(key)
    hi, lo = _counters(n, key.device)
    b0, b1 = threefry2x32(k0, k1, hi, lo)
    return (b0 ^ b1).reshape(key.shape[:-1] + shape)


def uniform(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` (float32 on [0, 1)) of each
    lane's key: the top 23 bits as a mantissa of 1.0, less 1, clamped at
    the lower bound."""
    bits = (random_bits(key, shape) >> MANTISSA_SHIFT) | ONE_BITS
    return torch.clamp(bits.to(torch.int32).view(torch.float32) - 1.0, min=0.0)


def keep_mask_plain(key: torch.Tensor, mask: torch.Tensor, budget: int) -> torch.Tensor:
    """`keep_mask` as tensor operations (any device, no host read)."""
    from .masked import random_keep_mask

    return random_keep_mask(mask, budget, uniform(key, mask.shape[-1:]))


def _library() -> ctypes.CDLL:
    lib = build.load("threefry")
    if lib.threefry_split_launch.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.threefry_split_launch.argtypes = [p, i, i, p, p, p]
        lib.threefry_keep_mask_launch.argtypes = [p, p, i, i, i, p, p, p]
        lib.threefry_split_launch.restype = lib.threefry_keep_mask_launch.restype = i
    return lib


def _check_key(key: torch.Tensor, what: str) -> None:
    if key.dtype != torch.uint32 or key.dim() == 0 or key.shape[-1] != 2:
        raise ValueError(f"{what}: a key is a (..., 2) uint32 tensor, got "
                         f"{tuple(key.shape)} {key.dtype}")


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` of each lane's key, (..., 2) ->
    (..., num, 2) uint32: the kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    _check_key(key, "split")
    if key.device.type == "cpu":
        return split_plain(key, num)
    if key.device.type != "cuda":
        raise ValueError(f"split: unsupported device {key.device}")
    n_keys = key.numel() // 2
    if not (0 < num < 2 ** 31 and 0 < n_keys and n_keys * num < 2 ** 31):
        raise ValueError(f"split: {n_keys} keys into {num} each outside the kernel's range")
    dev = key.device
    out = torch.empty(key.shape[:-1] + (num, 2), dtype=torch.uint32, device=dev)
    global split_launches
    err = _library().threefry_split_launch(key.contiguous().data_ptr(), n_keys, num,
                                           out.data_ptr(), split_runs.address(dev),
                                           torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry split kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        split_launches += 1
    return out


def keep_mask(key: torch.Tensor, mask: torch.Tensor, budget: int) -> torch.Tensor:
    """``random_keep_mask`` of the JAX package drawn from a key: the (..., N)
    bool ``mask`` thinned lane by lane with ``uniform(key, (N,))`` of the
    lane's (..., 2) uint32 key (module doc).  The kernel on a CUDA tensor,
    the plain version on a CPU tensor."""
    _check_key(key, "keep_mask")
    if mask.device.type == "cpu":
        return keep_mask_plain(key, mask, budget)
    if mask.device.type != "cuda":
        raise ValueError(f"keep_mask: unsupported device {mask.device}")
    n = mask.shape[-1] if mask.dim() else 0
    lanes = mask.numel() // max(n, 1)
    if (mask.dtype != torch.bool or mask.dim() == 0 or key.shape[:-1] != mask.shape[:-1]
            or key.device != mask.device):
        raise ValueError("keep_mask: a (..., N) bool mask and a (..., 2) uint32 key a lane "
                         "on one device")
    if not (0 < n < 2 ** 31 and 0 < lanes <= MAX_LANES and 0 <= budget < 2 ** 31):
        raise ValueError(f"keep_mask: {lanes} lanes of {n} entries, budget {budget}, "
                         "outside the kernel's range")
    dev = mask.device
    out = torch.empty_like(mask, memory_format=torch.contiguous_format)
    global mask_launches
    err = _library().threefry_keep_mask_launch(
        key.contiguous().data_ptr(), mask.contiguous().data_ptr(), lanes, n, int(budget),
        out.data_ptr(), mask_runs.address(dev), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"threefry keep-mask kernel launch failed: CUDA error {err}")
    if not torch.cuda.is_current_stream_capturing():
        mask_launches += 1
    return out
