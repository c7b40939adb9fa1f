"""The requests a run holds for the check after its window, drawn from the
seed. Request i has a seeded key, uniform on [0, 2^63); it is held

  by share:  where its key lies below share * 2^63, and request 0 always:
             about share of the window's requests, spread evenly over it,
             whatever the window's count turns out to be;
  by size:   while its key is among the `size` smallest seen so far (a
             bottom-k sketch): a uniform sample of `size` requests, which
             holds every one of the first `size` and fewer later on.

The choice is made before a request runs, so that only held requests pay
for their capture.
"""

from __future__ import annotations

from pbench import data

KEY_SPAN = 1 << 63


class Sample:
    def __init__(self, seed: int, size: int | None = None,
                 share: float | None = None):
        if (size is None) == (share is None):
            raise ValueError("give a sample's size or its share, not both")
        self.seed = seed
        self.size = size
        self.cut = None if share is None else int(share * KEY_SPAN)
        self.held: dict[int, object] = {}
        self._keys: dict[int, int] = {}

    def key(self, i: int) -> int:
        return data.sub_seed(self.seed, data.SAMPLE, i)

    def wants(self, i: int) -> bool:
        """Whether request i would enter the sample."""
        if self.cut is not None:
            return i == 0 or self.key(i) < self.cut
        if len(self.held) < self.size:
            return True
        return self.key(i) < max(self._keys.values())

    def add(self, i: int, item) -> None:
        self.held[i] = item
        if self.cut is not None:
            return
        self._keys[i] = self.key(i)
        if len(self.held) > self.size:
            drop = max(self._keys, key=self._keys.get)
            del self.held[drop], self._keys[drop]
