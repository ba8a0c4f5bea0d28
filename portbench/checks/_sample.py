"""The calls of the window that a check compares: a sample drawn from the
seed, always with the largest call in it."""

import numpy as np


def pick(seed, sizes, n, salt):
    """Indices of up to `n` of the calls whose sizes are `sizes`: the
    largest, then others drawn from `seed`."""
    if not len(sizes):
        return []
    first = int(np.argmax(sizes))
    rest = [i for i in range(len(sizes)) if i != first]
    rng = np.random.default_rng([seed % (2**62), salt])
    more = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest and n > 1 else []
    return sorted([first] + [rest[int(i)] for i in more])
