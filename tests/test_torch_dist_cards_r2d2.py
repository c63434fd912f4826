"""The R2D2 cases of tests/test_torch_dist_cards.py on the two dp=4
layouts (four card groups; [cpu:0 .. cpu:3] * 2 with the LSTM split):
the per-card sequence learner against the JAX package's
`DistSequenceLearner` (3e-2) and the port's stacked learner (1e-2) over
one K=4 macro-step, as that file sets out."""

import pytest

from tests.test_torch_dist_cards import check_layout


@pytest.mark.parametrize("layout", ["dp4xtp1", "cpus_x2_dp4xtp2"])
def test_card_groups_match_jax_and_the_stacked_learner(layout):
    check_layout("lstm_bf16", layout)
