"""Hyper-parameter search strategies for SkewScout's communication control
(§7.2: "hill climbing, stochastic hill climbing, and simulated annealing").

All tuners operate on a discrete ladder of θ values ordered from most
communication-heavy (index 0) to most relaxed (last).  They minimize the
memoized objective J(θ) from Eq. 1.
"""
from __future__ import annotations

import math
import random
from typing import Dict, List, Optional


class LadderTuner:
    def __init__(self, ladder: List, start_index: Optional[int] = None):
        self.ladder = list(ladder)
        self.i = len(ladder) // 2 if start_index is None else start_index
        self.memo: Dict[int, float] = {}

    @property
    def theta(self):
        return self.ladder[self.i]

    def observe(self, objective: float) -> None:
        self.memo[self.i] = objective

    def propose(self) -> int:
        raise NotImplementedError

    def step(self, objective: float):
        """Record J(θ_current) and move.  Returns the new θ."""
        self.observe(objective)
        self.i = self.propose()
        return self.theta


class HillClimb(LadderTuner):
    """Greedy neighbour descent with memoization (paper's best performer)."""

    def propose(self) -> int:
        best_i, best_j = self.i, self.memo.get(self.i, math.inf)
        for n in (self.i - 1, self.i + 1):
            if 0 <= n < len(self.ladder):
                jn = self.memo.get(n)
                if jn is None:
                    return n                      # explore unseen neighbour
                if jn < best_j:
                    best_i, best_j = n, jn
        return best_i


class StochasticHillClimb(LadderTuner):
    def __init__(self, ladder, start_index=None, seed: int = 0):
        super().__init__(ladder, start_index)
        self.rng = random.Random(seed)

    def propose(self) -> int:
        cands = [n for n in (self.i - 1, self.i, self.i + 1)
                 if 0 <= n < len(self.ladder)]
        weights = []
        for n in cands:
            j = self.memo.get(n)
            weights.append(1.0 if j is None else math.exp(-j))
        total = sum(weights)
        r = self.rng.random() * total
        for n, w in zip(cands, weights):
            r -= w
            if r <= 0:
                return n
        return cands[-1]


class SimulatedAnnealing(LadderTuner):
    def __init__(self, ladder, start_index=None, seed: int = 0,
                 temp0: float = 1.0, decay: float = 0.9):
        super().__init__(ladder, start_index)
        self.rng = random.Random(seed)
        self.temp = temp0
        self.decay = decay

    def propose(self) -> int:
        cands = [n for n in (self.i - 1, self.i + 1)
                 if 0 <= n < len(self.ladder)]
        n = self.rng.choice(cands)
        j_cur = self.memo.get(self.i, math.inf)
        j_new = self.memo.get(n)
        self.temp *= self.decay
        if j_new is None or j_new < j_cur:
            return n
        if self.rng.random() < math.exp(-(j_new - j_cur)
                                        / max(self.temp, 1e-6)):
            return n
        return self.i


def make_tuner(kind: str, ladder: List, **kw) -> LadderTuner:
    return {"hill": HillClimb, "stochastic": StochasticHillClimb,
            "anneal": SimulatedAnnealing}[kind](ladder, **kw)
