"""Size helpers of the reference's ops/octree.py.

Only `next_pow2` and `bucket` are ported so far; the SVO/DAG build waits
in ROADMAP Queue 1 #11.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    n = max(int(n), 1)
    return 1 << (n - 1).bit_length()


def bucket(n: int, floor: int = 8) -> int:
    """Padded size for a dynamic count: the next power of two, at least
    `floor`."""
    return max(next_pow2(n), floor)
