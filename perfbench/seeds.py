"""Every random draw of the benchmark comes from (--seed, a stream name, an
index) alone, so one seed gives one set of inputs, and the streams of one
seed are independent of each other."""

from __future__ import annotations

import zlib

import numpy as np


def _entropy(seed: int, stream: str, *index: int) -> list:
    return [int(seed) % (1 << 63), zlib.crc32(stream.encode()),
            *(int(i) for i in index)]


def rng(seed: int, stream: str, *index: int) -> np.random.Generator:
    return np.random.default_rng(_entropy(seed, stream, *index))


def key(seed: int, stream: str, *index: int) -> int:
    """A 63-bit seed for a torch.Generator."""
    state = np.random.SeedSequence(_entropy(seed, stream, *index))
    return int(state.generate_state(1, np.uint64)[0] >> np.uint64(1))


def sphere(n: int) -> np.ndarray:
    """n unit vectors spread evenly over the sphere (a Fibonacci lattice)."""
    k = np.arange(n) + 0.5
    z = 1.0 - 2.0 * k / n
    phi = np.pi * (3.0 - np.sqrt(5.0)) * k
    r = np.sqrt(1.0 - z * z)
    return np.stack([r * np.cos(phi), r * np.sin(phi), z], axis=1)


def cycle(seed: int, stream: str, items: np.ndarray):
    """The items over and over, each pass in its own order drawn from the
    seed: every seed gets the same work, in another order."""
    g = rng(seed, stream)
    while True:
        yield from items[g.permutation(len(items))]
