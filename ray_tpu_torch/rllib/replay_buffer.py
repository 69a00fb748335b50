"""Replay buffers for off-policy algorithms.

Counterpart of ``ray_tpu/rllib/replay_buffer.py``, kept as a copy of its
own (the port imports nothing of ``ray_tpu``): numpy ring buffers, so a
whole sample() lands on the device in one transfer for the update, and
the same ``np.random.default_rng(seed)`` draws, so the same seed gives
the same samples as the reference.  Prioritized sampling uses a segment
tree over priorities (the PER paper), with O(log n) updates.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform ring-buffer replay of transition dicts."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = int(capacity)
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: Dict[str, np.ndarray]):
        """Append a batch of transitions; each value is [B, ...]."""
        n = len(next(iter(batch.values())))
        if self._store is None:
            self._store = {
                k: np.zeros((self.capacity,) + np.asarray(v).shape[1:],
                            np.asarray(v).dtype)
                for k, v in batch.items()}
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._store[k][idx] = v
        self._next = (self._next + n) % self.capacity
        self._size = min(self._size + n, self.capacity)
        return idx

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, batch_size)
        out = {k: v[idx] for k, v in self._store.items()}
        out["_indices"] = idx
        return out

    def update_priorities(self, indices, priorities):
        pass  # uniform buffer: no-op (keeps the caller generic)


class _SumTree:
    """Binary-indexed segment tree: prefix-sum sampling in O(log n)."""

    def __init__(self, capacity: int):
        self.n = 1
        while self.n < capacity:
            self.n *= 2
        self.tree = np.zeros(2 * self.n, np.float64)

    def set(self, idx: int, value: float):
        i = self.n + idx
        self.tree[i] = value
        i //= 2
        while i >= 1:
            self.tree[i] = self.tree[2 * i] + self.tree[2 * i + 1]
            i //= 2

    def total(self) -> float:
        return float(self.tree[1])

    def find(self, prefix: float) -> int:
        i = 1
        while i < self.n:
            left = self.tree[2 * i]
            if prefix < left:
                i = 2 * i
            else:
                prefix -= left
                i = 2 * i + 1
        return i - self.n


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized replay (PER): P(i) ∝ p_i^alpha, with
    importance weights (1/(N·P(i)))^beta returned per sample."""

    def __init__(self, capacity: int, alpha: float = 0.6, beta: float = 0.4,
                 seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self.beta = beta
        self._tree = _SumTree(self.capacity)
        self._max_prio = 1.0

    def add(self, batch: Dict[str, np.ndarray]):
        idx = super().add(batch)
        for i in idx:
            self._tree.set(int(i), self._max_prio ** self.alpha)
        return idx

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        total = self._tree.total()
        # stratified: one draw per equal-mass segment
        bounds = np.linspace(0, total, batch_size + 1)
        draws = self._rng.uniform(bounds[:-1], bounds[1:])
        idx = np.array([min(self._tree.find(d), self._size - 1)
                        for d in draws])
        probs = np.array([max(self._tree.tree[self._tree.n + i], 1e-12)
                          for i in idx]) / max(total, 1e-12)
        weights = (self._size * probs) ** (-self.beta)
        weights /= weights.max()
        out = {k: v[idx] for k, v in self._store.items()}
        out["_indices"] = idx
        out["_weights"] = weights.astype(np.float32)
        return out

    def update_priorities(self, indices, priorities):
        for i, p in zip(np.asarray(indices), np.asarray(priorities)):
            p = float(abs(p)) + 1e-6
            self._max_prio = max(self._max_prio, p)
            self._tree.set(int(i), p ** self.alpha)
