"""The one generator of the benchmark's traffic.

A traffic file of ``workloads/`` states a loop of time steps.  The one mix
so far, ``whole``, has no parameter: the configuration's whole mesh on one
chip, chained steps issued free-running.  This module gives the loop its
warm-up, and draws from the seed the window's steps and elements that are
compared with the plain reference.
"""

from __future__ import annotations

import random

# steps run in set-up before the window, twice over (see ``run.warm_up``)
WARMUP_STEPS = 4
# the window's steps compared on a sample of elements: every step of a
# window expected to hold no more, else step 0 and the rest drawn
CHECKED_STEPS = 64
# elements in that sample, drawn once per run
SAMPLE_ELEMENTS = 8192


def checked_steps(seed: int, steps_expected: int) -> set:
    """Indices of the window's steps compared on the sample of elements
    (the last step is compared in full besides)."""
    if steps_expected <= CHECKED_STEPS:
        return set(range(steps_expected))
    drawn = random.Random(seed).sample(range(1, steps_expected),
                                       CHECKED_STEPS - 1)
    return {0, *drawn}


def sample_elements(seed: int, n_elements: int) -> list:
    """The elements those steps are compared on, in increasing order:
    every element of a mesh of no more than ``SAMPLE_ELEMENTS``, else that
    many drawn from *seed*."""
    if n_elements <= SAMPLE_ELEMENTS:
        return list(range(n_elements))
    return sorted(random.Random(f"elements {seed}").sample(
        range(n_elements), SAMPLE_ELEMENTS))
