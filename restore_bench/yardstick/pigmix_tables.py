"""The PigMix tables, frozen from ``repro_torch/workloads/pigmix.py``
with the same draws: ``page_views`` (user, action, timespent,
query_term, timestamp, estimated_revenue), ``users`` (name, phone, zip)
and ``power_users`` (name, phone).  Strings are fixed-width (n, 20)
uint8 rows, zero-padded, as the program stores them.  Returns numpy
columns; the benchmark hands the same arrays to the program and to the
reference."""
from __future__ import annotations

from typing import Dict

import numpy as np

WIDTH = 20
POWER_USERS_FROM = 200      # power_users: every 4th of user0000..user0199


def encode(values, width: int = WIDTH) -> np.ndarray:
    out = np.zeros((len(values), width), dtype=np.uint8)
    for i, s in enumerate(values):
        b = s.encode("utf-8")[:width]
        out[i, :len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def _vocab_column(rng, vocab, n_rows):
    return encode(vocab)[rng.integers(0, len(vocab), n_rows)]


def page_views(n_rows: int, seed: int, n_users: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    users = [f"user{i:04d}" for i in range(n_users)]
    terms = [f"term{i:03d}" for i in range(50)]
    return {
        "user": _vocab_column(rng, users, n_rows),
        "action": rng.integers(1, 3, n_rows).astype(np.int32),
        "timespent": rng.integers(0, 100, n_rows).astype(np.int32),
        "query_term": _vocab_column(rng, terms, n_rows),
        "timestamp": rng.integers(0, 24, n_rows).astype(np.int32),
        "estimated_revenue": rng.uniform(0, 100, n_rows).astype(np.float32),
    }


def users(seed: int, n_users: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    names = [f"user{i:04d}" for i in range(n_users)]
    return {
        "name": encode(names),
        "phone": rng.integers(10**6, 10**7, n_users).astype(np.int32),
        "zip": rng.integers(10**4, 10**5, n_users).astype(np.int32),
    }


def power_users(seed: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    names = [f"user{i:04d}" for i in range(0, POWER_USERS_FROM, 4)]
    return {
        "name": encode(names),
        "phone": rng.integers(10**6, 10**7, len(names)).astype(np.int32),
    }


def tables(seed: int, n_rows: int, n_users: int) -> Dict[str, Dict]:
    """All three from one run seed: page_views from ``seed``, users from
    ``seed + 1``, power_users from ``seed + 2``."""
    return {"page_views": page_views(n_rows, seed, n_users),
            "users": users(seed + 1, n_users),
            "power_users": power_users(seed + 2)}
