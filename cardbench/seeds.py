"""Seeds derived from the run's --seed: one stream a purpose, so that the
data, each job's starting point and the checked sample never share draws."""
from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A seed in [0, 2**62) fixed by --seed and the tags."""
    text = ":".join(str(t) for t in (int(seed),) + tags)
    return int(hashlib.sha256(text.encode()).hexdigest()[:15], 16) >> 2
