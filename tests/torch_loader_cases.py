"""A dataset for the loader tests of ``tests/test_torch_data.py`` that the
loader's worker processes can import (this module imports neither JAX nor
torch): its samples depend on an attribute changed between epochs, as the
benchmark's ``_Keyed.epoch`` is."""

import random


class Epochal:
    """`base`'s samples, each drawn from a stream of the loader's stream
    and ``epoch``, which the caller sets before an epoch."""

    def __init__(self, base):
        self.base, self.epoch = base, 0

    def __len__(self):
        return len(self.base)

    def get(self, idx, rng):
        return self.base.get(
            idx, random.Random(rng.getrandbits(31) + 1_000_003 * self.epoch))
