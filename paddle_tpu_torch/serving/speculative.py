"""N-gram speculative decoding: the host-side draft proposer
(counterpart of ``paddle_tpu/serving/speculative.py``).

Speculative decoding splits a decode step into a draft (cheap guesses at
the next k tokens) and a verify (one target-model forward over all k+1
positions, accepting the longest prefix the model agrees with). The
verify is in the engine (``inference/serving.py`` ``_paged_verify``);
this module is the draft. The n-gram proposer ("prompt lookup decoding")
needs no draft model: it matches the sequence's trailing n-gram against
its earlier history and proposes the tokens that followed last time.
Speculation never changes greedy output, only how many tokens one
program yields.

Any object with ``propose(context) -> list[int]`` (at most ``k``
tokens) and a ``k`` attribute can be given as ``PagedEngine(speculate=)``.
The JAX package's process-wide proposed/accepted counters come with the
port's metrics registry in a later slice; the engine keeps its own
``spec_proposed``/``spec_accepted``.
"""
from __future__ import annotations

from typing import List, Sequence

__all__ = ["NgramProposer"]


class NgramProposer:
    """Draft ``k`` tokens by n-gram lookup in the request's own history.

    Tries the longest trailing n-gram first (``max_n`` down to ``min_n``):
    scans the context right to left for its most recent earlier
    occurrence and proposes the tokens that followed it. Returns at most
    ``k`` tokens; none when the history has no match.
    """

    def __init__(self, k: int = 4, max_n: int = 3, min_n: int = 1):
        if k < 1:
            raise ValueError("k must be >= 1")
        if not 1 <= min_n <= max_n:
            raise ValueError("need 1 <= min_n <= max_n")
        self.k = k
        self.max_n = max_n
        self.min_n = min_n

    def propose(self, context: Sequence[int]) -> List[int]:
        ctx = list(context)
        L = len(ctx)
        for n in range(min(self.max_n, L - 1), self.min_n - 1, -1):
            tail = ctx[L - n:]
            # most recent earlier occurrence of the trailing n-gram
            for j in range(L - n - 1, -1, -1):
                if ctx[j:j + n] == tail:
                    cont = ctx[j + n:j + n + self.k]
                    if cont:
                        return cont
        return []
