"""Start-and-length indicator value (TS 38.214 §5.1.2.1; reference
lib/ran/sliv.cpp)."""
from __future__ import annotations


def sliv_encode(n: int, start: int, length: int) -> int:
    """S, L → SLIV within an N-symbol/PRB window (1 ≤ L ≤ N − S)."""
    assert 1 <= length <= n - start, (n, start, length)
    if (length - 1) <= n // 2:
        return n * (length - 1) + start
    return n * (n - length + 1) + (n - 1 - start)


def sliv_decode(n: int, sliv: int) -> tuple[int, int]:
    """SLIV → (start, length)."""
    length = sliv // n + 1
    start = sliv % n
    if start + length > n:
        length = n - length + 2
        start = n - 1 - start
    return start, length
