"""A cell's inputs: its datasets and its sequence of requests, from the seed.

The configuration names the database (`dataset`: a Table 1 spec for the
copied generator) and the query; the traffic mix names the generator seeds
of the datasets it cycles (`generator_seeds`) and the parameters its
requests cycle (`params`).  Request i asks query `params[i % len(params)]`
of dataset `i % len(generator_seeds)`, in that order from the first.

`--seed` reorders each dataset's transactions (bits and labels together)
by a permutation drawn from it.  Every itemset keeps its supports, so every
seed gives the program the same work in the same order on other bits, and
the reference another input to answer.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import synthetic

__all__ = ["Input", "make_inputs", "request", "distinct_requests"]


@dataclass(frozen=True)
class Input:
    """One dataset as the benchmark made it: packed words and labels."""

    gen_seed: int
    db_bits: np.ndarray   # [M, W] uint32, bit t of word w = transaction 32 w + t
    labels: np.ndarray    # [N] bool
    n_transactions: int

    def dense(self) -> np.ndarray:
        """[N, M] bool: the raw matrix the reference reads."""
        return synthetic.unpack_words(self.db_bits, self.n_transactions).T


def make_inputs(config: dict, traffic: dict, seed: int) -> list[Input]:
    d = config["dataset"]
    out = []
    for g in traffic["generator_seeds"]:
        spec = synthetic.SyntheticSpec(
            name=d["name"], n_items=d["n_items"], n_transactions=d["n_transactions"],
            density=d["density"], n_pos=d["n_pos"], n_planted=d["n_planted"],
            planted_pos_rate=d["planted_pos_rate"], planted_neg_rate=d["planted_neg_rate"],
            skew=d["skew"], seed=int(g))
        bits, labels, _ = synthetic.generate_packed(spec)
        perm = np.random.default_rng([int(seed), int(g)]).permutation(spec.n_transactions)
        bits, labels = synthetic.permute_transactions(bits, labels, perm)
        out.append(Input(int(g), bits, labels, spec.n_transactions))
    return out


def request(traffic: dict, i: int) -> tuple[int, int]:
    """(dataset index, params index) of request i."""
    return i % len(traffic["generator_seeds"]), i % len(traffic["params"])


def distinct_requests(traffic: dict, n: int) -> list[tuple[int, int]]:
    """The distinct (dataset, params) pairs among the first n requests."""
    return sorted({request(traffic, i) for i in range(n)})
