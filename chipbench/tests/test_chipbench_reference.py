"""The reference against the port on the CPU, and the copied generator
against the program's, at test size."""

from __future__ import annotations

import numpy as np
import pytest

from chipbench.harness import data, synthetic
from chipbench.harness.judge import compare
from chipbench.harness.queries import answer_of, program_query, reference_answer
from chipbench.reference.closed import closed_itemsets, round_bfloat16


@pytest.mark.parametrize("name,scale", [("hapmap_dom_20", 0.01), ("alz_rec_30", 0.0005)])
def test_generator_copy_equals_the_program_generator(name, scale):
    from repro_torch.data.synthetic import paper_problem_packed

    bits, labels, planted, spec = paper_problem_packed(name, scale_items=scale, seed=5)
    mine = synthetic.SyntheticSpec(spec.name, spec.n_items, spec.n_transactions,
                                   spec.density, spec.n_pos, seed=5)
    bits2, labels2, planted2 = synthetic.generate_packed(mine)
    assert np.array_equal(bits, bits2) and np.array_equal(labels, labels2)
    assert planted == planted2


def test_permuting_transactions_keeps_every_closed_set():
    spec = synthetic.SyntheticSpec("t", 40, 75, 0.25, 30, seed=3)
    bits, labels, _ = synthetic.generate_packed(spec)
    perm = np.random.default_rng(2**31 + 11).permutation(75)
    bits2, labels2 = synthetic.permute_transactions(bits, labels, perm, item_chunk=7)
    db, db2 = synthetic.unpack_words(bits, 75).T, synthetic.unpack_words(bits2, 75).T
    assert np.array_equal(db2, db[perm]) and np.array_equal(labels2, labels[perm])
    assert sorted(closed_itemsets(db, labels, 5)) == sorted(closed_itemsets(db2, labels2, 5))


def test_closed_sets_equal_the_brute_force_oracle():
    from repro_torch.core.lcm import brute_force_closed

    rng = np.random.default_rng(7)
    db = rng.random((30, 12)) < 0.4
    got = {frozenset(items): sup for items, sup, _ in
           closed_itemsets(db, np.zeros(30, bool), 2)}
    assert got == brute_force_closed(db, 2)


def test_bfloat16_rounding():
    x = np.array([1, 255, 256, 257, 347, 348, 349, 364], dtype=np.float32)
    assert round_bfloat16(x).tolist() == [1, 255, 256, 256, 348, 348, 348, 364]


@pytest.mark.parametrize("kind", ["significant", "closed"])
@pytest.mark.parametrize("reseed", [None] + [2**31 + 100 + k for k in range(12)])
def test_reference_equals_the_port_on_the_cpu(cell_factory, kind, reseed):
    """The mix's datasets with their transactions reordered by a seed, and
    datasets drawn anew from each of a dozen seeds (`readings.py
    --reseed`): other supports, the same answers."""
    from repro_torch.api import Dataset, MinerSession

    from chipbench.readings import reseeded

    cell = cell_factory(kind)
    seed = 2**31 + 5
    if reseed is not None:
        cell, seed = reseeded(cell, reseed), reseed
    inputs = data.make_inputs(cell.config, cell.traffic, seed=seed)
    assert [x.gen_seed for x in inputs] == [seed + g if reseed else g for g in (0, 1, 2)]
    session = MinerSession(4, device="cpu")
    n = 0
    for d, q in data.distinct_requests(cell.traffic, 6):
        x, params = inputs[d], cell.traffic["params"][q]
        ds = Dataset.from_packed_words(x.db_bits, x.labels, n_transactions=x.n_transactions,
                                       device="cpu")
        got = answer_of(session.run(ds, program_query(cell.config, params)))
        want = reference_answer(cell.config, x.dense(), x.labels, params)
        same, gap = compare(got, want)
        assert same and gap < 1e-9, (d, q, gap)
        n += len(want["patterns"])
    assert n > 0
