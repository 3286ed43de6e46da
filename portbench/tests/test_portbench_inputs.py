"""The benchmark's own generator makes the inputs the program's synthetic
generator makes from the same seed, and the reference's statements agree with
the program's own public-input roots."""

import numpy as np
import pytest

from eth_lc_plonky2_tpu_torch.eth.synthetic import make_synthetic_update_pair
from portbench import updates
from portbench.reference import lc_dummy


@pytest.mark.parametrize("size", [8, 16])
def test_generator_is_the_programs(size):
    kwargs, raw = updates.make_update(np.random.default_rng(7), size, size)
    syn = make_synthetic_update_pair(size, seed=7)
    assert kwargs == syn.witness_kwargs


def test_statement_is_the_contract_state_roots():
    kwargs, raw = updates.make_update(updates.rng_for(2**31 + 5, 0), 8, 8)
    limbs = lc_dummy.expected_public_inputs(raw)
    roots = b"".join(v.to_bytes(4, "big") for v in limbs)
    assert roots == kwargs["cur_state"] + kwargs["new_state"]


def test_seeds_give_other_inputs_of_the_same_sizes():
    a = updates.make_update(updates.rng_for(1, 0), 8, 8)[0]
    b = updates.make_update(updates.rng_for(1 + 2**40, 0), 8, 8)[0]
    assert a["signing_root"] != b["signing_root"]
    assert {k: np.shape(v) for k, v in a.items()} == {k: np.shape(v) for k, v in b.items()}
