"""The port's non-adversarial tasks against the JAX package's: Autoencoder,
VAE, DoubleAE and DoubleVAE (``models/tasks/simple.py``). Sizes and
tolerances: tests/torch_families.py."""

import pytest
from torch_families import (
    check_bridge,
    check_eval,
    check_full_width_sites,
    check_generate,
    check_train_step,
    run_pair,
)

# the share of parameter elements that the port's first Adam step moved the
# other way than JAX's (the gradient's sign differs where it is rounding
# noise): measured 0.0130, 0.0015, 0.0187, 0.0045; bounds about twice that
# (a wrong gradient flips about half)
FLIPPED = {"autoencoder": 0.03, "vae": 0.01, "doubleae": 0.04,
           "doublevae": 0.01}


@pytest.fixture(scope="module", params=sorted(FLIPPED))
def pair(request):
    return request.param, run_pair(request.param)


def test_weight_bridge_round_trip(pair):
    check_bridge(pair[1])


def test_generate_matches_jax(pair):
    check_generate(pair[1])


def test_eval_step_matches_jax(pair):
    check_eval(pair[1])


def test_train_step_matches_jax(pair):
    name, out = pair
    check_train_step(out, name, FLIPPED[name])


# per step at 256x256, base 64, bf16, batch 4 (in_act, reflect conv,
# zero_same dx, dw): 5 IN sites and U4 + tail per generator pass, dx of U4
# and the tail, dw of head, U4 and tail; the heads take data
SITES = {"autoencoder": (1, 1), "vae": (1, 1), "doubleae": (2, 2),
         "doublevae": (2, 2)}


@pytest.mark.parametrize("name", sorted(SITES))
def test_full_width_training_sites_match_jax_tpu_path(monkeypatch, name):
    passes, data_fed = SITES[name]
    check_full_width_sites(monkeypatch, name, {
        "in_act": 5 * passes, "starved_conv": 2 * passes,
        "starved_conv_dx": 2 * passes, "starved_conv_dw": 3 * passes},
        data_fed)
