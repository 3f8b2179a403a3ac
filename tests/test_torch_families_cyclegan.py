"""The port's CycleAEGAN task (``models/tasks/cyclegan.py``; CycleVAEGAN has
tests/test_torch_train.py) against the JAX package's: the non-variational
branch of the cycle-GAN base, its own G_loss and no KL. A file of its own so
that the test workers spread the families' JAX compiles. Sizes and
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

NAME = "cycleaegan"
# share of parameter elements on the other Adam sign than JAX's (see
# tests/test_torch_families_simple.py): measured 0.0162
FLIPPED = 0.04


@pytest.fixture(scope="module")
def out():
    return run_pair(NAME)


def test_weight_bridge_round_trip(out):
    check_bridge(out)


def test_generate_matches_jax(out):
    check_generate(out)


def test_eval_step_matches_jax(out):
    check_eval(out)


def test_train_step_matches_jax(out):
    check_train_step(out, NAME, FLIPPED)


def test_full_width_training_sites_match_jax_tpu_path(monkeypatch):
    """256x256, base 64, bf16, batch 4: 6 generator passes (G(x), G(y),
    F(Gx), F(y), F(x), G(Fy)) x 5 IN sites + 8 D passes x 2; U4 and tail
    per pass, their dx and the head dx of F(Gx) and G(Fy); 3 dw per pass;
    four heads take data."""
    check_full_width_sites(monkeypatch, NAME, {
        "in_act": 46, "starved_conv": 12, "starved_conv_dx": 14,
        "starved_conv_dw": 18}, 4)
