"""The general generator of prompt lengths from a traffic file.

A mix names ``lengths`` and their ``steps`` a block: every block of
``sum(steps)`` steps holds each length exactly that many times, in an order
drawn from the seed, and a step of length ``L`` holds ``tokens_per_step //
L`` prompts.  Token ids are drawn on the device, uniformly over the
vocabulary, by the drivers.
"""
from __future__ import annotations

import itertools

import numpy as np


def rng(seed: int, stream: str) -> np.random.Generator:
    """A numpy generator for one purpose (``stream``) of a run: seeds of
    any size, streams independent of each other."""
    words = [int(b) for b in stream.encode()]
    return np.random.default_rng(np.random.SeedSequence(
        [int(seed) % (1 << 64), *words]))


def block(traffic: dict) -> list[int]:
    """One block's lengths, in the file's order."""
    return [L for L, n in zip(traffic["lengths"], traffic["steps"])
            for _ in range(n)]


def lengths(traffic: dict, seed: int):
    """The prompt length of every step, without end: blocks of
    :func:`block`, each in its own order drawn from ``seed``."""
    g = rng(seed, "lengths")
    base = np.asarray(block(traffic))
    while True:
        yield from (int(L) for L in g.permutation(base))


def batch_rows(traffic: dict, L: int) -> int:
    """Prompts in a step of length ``L``."""
    B = traffic["tokens_per_step"] // L
    if B < 1 or B * L != traffic["tokens_per_step"]:
        raise ValueError(f"length {L} does not divide the step's "
                         f"{traffic['tokens_per_step']} tokens")
    return B


def first_steps(traffic: dict, seed: int, n: int) -> list[int]:
    """The first ``n`` lengths of :func:`lengths`."""
    return list(itertools.islice(lengths(traffic, seed), n))
