"""The port's adversarial tasks against the JAX package's: AEGAN and VAEGAN
(``models/tasks/gan.py``), with the discriminator's init gain and VAEGAN's
rerun of D on the stored spectral vectors. Sizes and tolerances:
tests/torch_families.py."""

import math

import numpy as np
import pytest
import torch
from torch_families import (
    BASE,
    IMAGE,
    LATENT,
    check_bridge,
    check_eval,
    check_full_width_sites,
    check_generate,
    check_train_step,
    run_pair,
)
from vae_cyclegan_tpu_torch.config import ModelConfig
from vae_cyclegan_tpu_torch.models.tasks import create_task
from vae_cyclegan_tpu_torch.ops.initializers import kaiming_normal_fan_out

# share of parameter elements on the other Adam sign than JAX's (see
# tests/test_torch_families_simple.py): measured 0.0095 and 0.0045
FLIPPED = {"aegan": 0.02, "vaegan": 0.01}


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
    """The discriminator's gradient (measured within 4.9e-5 absolute for
    its biases ahead of an InstanceNorm, 3.6e-4 relative for the rest) and
    its spectral vectors after the step's four (AEGAN) or two kept (VAEGAN)
    power iterations (measured 1.5e-8) held tightly."""
    name, out = pair
    check_train_step(out, name, FLIPPED[name])


@pytest.mark.parametrize("name,gain2", [("aegan", 2.0),
                                        ("vaegan", 2.0 / (1 + 0.2 ** 2))])
def test_discriminator_init_gain(name, gain2):
    """AEGAN's composite re-initializes D with the relu gain; VAEGAN leaves
    it at the reference's own leaky_relu (a = 0.2) init; both generators
    take the relu gain. Each weight is drawn from the init's generator with
    its std."""
    task = create_task(name, model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.init(5)
    d_init = "relu" if gain2 == 2.0 else "leaky_relu"
    assert task.D.model[4].kernel_init_nonlinearity == d_init
    w = task.D.model[1].conv.weight.detach()  # (16, 8, 4, 4): std within 10%
    assert task.D.model[1].conv.kernel_init_nonlinearity == d_init
    cout, _, kh, kw = w.shape
    ratio = float(w.std()) / math.sqrt(gain2 / (cout * kh * kw))
    assert 0.9 < ratio < 1.1
    # the generator's draws come first, with the relu gain
    head = task.G.encoder.model[0].conv.weight
    want = kaiming_normal_fan_out(head.shape, torch.Generator().manual_seed(5))
    torch.testing.assert_close(head, want, rtol=0, atol=0)


def test_vaegan_d_step_reruns_the_stored_spectral_vectors():
    """VAEGAN keeps the spectral state of its generator step's two D calls;
    its D step starts its two calls from the vectors each of those calls
    started from (the same tensors put back) and leaves the kept state in
    place. (With one output channel the power iteration converges in one
    step, so the values alone cannot tell the states apart.)"""
    task = create_task("vaegan", model=ModelConfig(IMAGE, LATENT, BASE),
                       device="cpu")
    task.init(1)
    rng = np.random.RandomState(4)
    batch = {k: rng.rand(2, IMAGE, IMAGE, 3).astype(np.float32)
             for k in ("x", "y")}
    calls = []  # (state before, state after) of each D call
    forward = task.D.forward

    def spy(x, update_stats=False):
        before = task.D.spectral_state()
        out = forward(x, update_stats)
        calls.append((before, task.D.spectral_state(), update_stats))
        return out

    task.D.forward = spy
    start = task.D.spectral_state()
    task.train_step(batch)
    assert len(calls) == 4 and all(c[2] for c in calls)
    g1, g2, d1, d2 = calls

    def same(a, b):
        return all(s is t for s, t in zip(a, b))

    assert same(g1[0], start) and same(g2[0], g1[1])
    assert same(d1[0], g1[0]) and same(d2[0], g2[0])
    assert same(task.D.spectral_state(), g2[1])
    assert not any(a is b for a, b in zip(g2[1], g2[0]))


SITES = {"aegan": 2, "vaegan": 2}


@pytest.mark.parametrize("name", sorted(SITES))
def test_full_width_training_sites_match_jax_tpu_path(monkeypatch, name):
    """256x256, base 64, bf16, batch 4: G(x) and G(y), 4 D passes: 2 x 5 +
    4 x 2 IN sites, U4 and tail per generator pass, and their dx and the
    three dw; both heads take data."""
    check_full_width_sites(monkeypatch, name, {
        "in_act": 18, "starved_conv": 4, "starved_conv_dx": 4,
        "starved_conv_dw": 6}, SITES[name])
