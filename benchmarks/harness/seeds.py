"""Independent seeds for each stream of a run, derived from `--seed`."""

import hashlib


def derive(seed: int, stream: str) -> int:
    """A 63-bit seed for `stream`, the same for the same `seed` and name."""
    digest = hashlib.sha256(f"{seed}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
