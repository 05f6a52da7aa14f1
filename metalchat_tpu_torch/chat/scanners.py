"""Token scanners, the decode stop conditions (port of the JAX package's
``chat/scanners.py``): a stop-token set, a token budget and their
composite. ``scan(token) → bool`` says whether decoding should CONTINUE;
``reset()`` re-arms between reads.
"""

from __future__ import annotations

from typing import Iterable, Sequence


class TokenScanner:
    def scan(self, token: int) -> bool:  # pragma: no cover - interface
        raise NotImplementedError

    def reset(self) -> None:
        pass


class StopTokenScanner(TokenScanner):
    """Stop when the token is in the stop set."""

    def __init__(self, stop_ids: Iterable[int]):
        self.stop_ids = frozenset(stop_ids)

    def scan(self, token: int) -> bool:
        return token not in self.stop_ids


class LimitScanner(TokenScanner):
    """Stop after `limit` tokens (default 50)."""

    def __init__(self, limit: int = 50):
        self.limit = limit
        self._count = 0

    def scan(self, token: int) -> bool:
        self._count += 1
        return self._count <= self.limit

    def reset(self) -> None:
        self._count = 0


class CompositeScanner(TokenScanner):
    """Combine scanners with `all` (continue while every scanner says so) or
    `any` semantics."""

    def __init__(self, scanners: Sequence[TokenScanner], op: str = "all"):
        if op not in ("all", "any"):
            raise ValueError("op must be 'all' or 'any'")
        self.scanners = list(scanners)
        self.op = op

    def scan(self, token: int) -> bool:
        results = [s.scan(token) for s in self.scanners]  # evaluate all (stateful)
        return all(results) if self.op == "all" else any(results)

    def reset(self) -> None:
        for s in self.scanners:
            s.reset()
