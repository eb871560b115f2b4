"""Seeds derived from the run's ``--seed``: one stream per purpose, the same
in every process (a hash, not Python's salted ``hash``)."""

from __future__ import annotations

import hashlib


def derive(seed: int, *keys) -> int:
    """A 63-bit seed for ``(seed, *keys)``; ``seed`` may be any whole number."""
    text = repr((int(seed),) + tuple(str(k) for k in keys)).encode()
    return int.from_bytes(hashlib.blake2b(text, digest_size=8).digest(), "little") >> 1
