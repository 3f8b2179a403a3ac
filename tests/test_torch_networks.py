"""The port's blocks and networks against the JAX package's, on the same
weights (carried over by utils.jax_import.params_from_jax) and the same
reparameterization noise (numpy, injected on both sides).

Small size: image 64, base_width 16, latent_dim 8, batch 2, f32 on the CPU.
The JAX modules run through their plain XLA lowering here (no TPU). The
outer limit is the band of tests/test_reference_parity.py (atol 1e-3,
rtol 1e-2); the measured maximum errors are written beside each test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_cyclegan_tpu.models import blocks as jblocks
from vae_cyclegan_tpu.models import networks as jnets
from vae_cyclegan_tpu.parallel.dp import eps_queue
from vae_cyclegan_tpu.utils import torch_import
from vae_cyclegan_tpu_torch.models import blocks as tblocks
from vae_cyclegan_tpu_torch.models import networks as tnets
from vae_cyclegan_tpu_torch.utils.jax_import import params_from_jax

IMAGE, BASE, LATENT, BATCH = 64, 16, 8, 2
ATOL, RTOL = 1e-3, 1e-2


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return np.transpose(t.detach().float().numpy(), (0, 2, 3, 1))


def _close(got_nchw, want_nhwc):
    """assert_allclose at the parity band; returns the max abs error."""
    got = _nhwc(got_nchw)
    want = np.asarray(want_nhwc)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    err = float(np.abs(got - want).max())
    return err


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def vae():
    """The JAX VAE generator's params and the port's net loaded from them."""
    key = jax.random.PRNGKey(0)
    x = jnp.zeros((1, IMAGE, IMAGE, 3), jnp.float32)
    jnet = jnets.VariationalAutoencoderNet(LATENT, BASE)
    tree = _np_tree(jnet.init({"params": key, "reparam": key}, x)["params"])
    tnet = tnets.VariationalAutoencoderNet(LATENT, BASE)
    tnet.load_state_dict(params_from_jax(tree), strict=True)
    return tree, tnet


def _images(seed, shape=(BATCH, IMAGE, IMAGE, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def test_encoder_matches_jax(vae):
    """measured max error 5.9e-5 (outputs up to 6.0)"""
    tree, tnet = vae
    x = _images(1)
    want = jnets.Encoder(BASE).apply({"params": tree["encoder"]}, x)
    with torch.no_grad():
        got = tnet.encoder(_nchw(x))
    assert got.shape == (BATCH, 16 * BASE, IMAGE // 16, IMAGE // 16)
    _close(got, want)


def test_decoder_matches_jax(vae):
    """measured max error 4.6e-5 (outputs up to 13.8)"""
    tree, tnet = vae
    h = np.random.RandomState(2).randn(
        BATCH, IMAGE // 16, IMAGE // 16, 16 * BASE).astype(np.float32)
    want = jnets.Decoder(BASE).apply({"params": tree["decoder"]}, h)
    with torch.no_grad():
        got = tnet.decoder(_nchw(h))
    assert got.shape == (BATCH, 3, IMAGE, IMAGE)
    _close(got, want)


def test_variational_blocks_match_jax_with_injected_eps(vae):
    """z, mu, logvar and the decoder block; measured max errors 2.8e-4
    (z up to 310: logvar sits at its clip of 10), 9.8e-6, 1.1e-5, 5.2e-5"""
    tree, tnet = vae
    s = IMAGE // 16
    h = np.random.RandomState(3).randn(BATCH, s, s, 16 * BASE).astype(np.float32)
    eps = np.random.RandomState(4).randn(BATCH, s, s, LATENT).astype(np.float32)
    with eps_queue([jnp.asarray(eps)]):
        z, mu, logvar = jnets.VariationalEncoderBlock(LATENT).apply(
            {"params": tree["variational_encoder_block"]}, h,
            rngs={"reparam": jax.random.PRNGKey(9)})
    with torch.no_grad():
        tz, tmu, tlv = tnet.variational_encoder_block(_nchw(h), eps=_nchw(eps))
        tdec = tnet.variational_decoder_block(tz)
    for got, want in ((tz, z), (tmu, mu), (tlv, logvar)):
        _close(got, want)
    want_dec = jnets.VariationalDecoderBlock(16 * BASE).apply(
        {"params": tree["variational_decoder_block"]}, z)
    _close(tdec, want_dec)
    # the noise really is the injected one: a different eps moves z
    with torch.no_grad():
        tz2, _, _ = tnet.variational_encoder_block(_nchw(h),
                                                   eps=_nchw(eps * 0.0))
    assert not torch.allclose(tz, tz2)
    torch.testing.assert_close(tz2, tmu)


def test_vae_net_matches_jax_with_injected_eps(vae):
    """Gx, mu, logvar of the whole generator; measured max errors 2.0e-4
    (Gx up to 15.4), 2.2e-4 (mu up to 25.8), 2.1e-4"""
    tree, tnet = vae
    x = _images(5)
    s = IMAGE // 16
    eps = np.random.RandomState(6).randn(BATCH, s, s, LATENT).astype(np.float32)
    with eps_queue([jnp.asarray(eps)]):
        gx, mu, logvar = jnets.VariationalAutoencoderNet(LATENT, BASE).apply(
            {"params": tree}, x, rngs={"reparam": jax.random.PRNGKey(9)})
    with torch.no_grad():
        tgx, tmu, tlv = tnet(_nchw(x), eps=_nchw(eps))
    _close(tgx, gx)
    _close(tmu, mu)
    _close(tlv, logvar)


def test_vae_net_draws_noise_from_generator(vae):
    _, tnet = vae
    x = _nchw(_images(7))
    with torch.no_grad():
        a = tnet(x, generator=torch.Generator().manual_seed(3))[0]
        b = tnet(x, generator=torch.Generator().manual_seed(3))[0]
        c = tnet(x, generator=torch.Generator().manual_seed(4))[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.allclose(a, c)


def test_autoencoder_net_matches_jax():
    """measured max error 2.3e-4 (outputs up to 14.5)"""
    key = jax.random.PRNGKey(1)
    x = _images(8)
    jnet = jnets.AutoencoderNet(BASE)
    tree = _np_tree(jnet.init(key, x[:1])["params"])
    tnet = tnets.AutoencoderNet(BASE)
    tnet.load_state_dict(params_from_jax(tree), strict=True)
    with torch.no_grad():
        got = tnet(_nchw(x))
    _close(got, jnet.apply({"params": tree}, x))


# CaSb in the discriminator's form (k4, stride 2, reflect pad 1) and the
# generator's (k7, SAME), with and without the norm
CASB_CASES = [
    dict(kernel_size=4, stride=2, padding=1, activation="LeakyReLU"),
    dict(kernel_size=4, stride=2, padding=1, activation="LeakyReLU",
         use_norm=False),
    dict(kernel_size=7, stride=1, padding=3, activation="ReLU"),
    dict(kernel_size=7, stride=1, padding=3, activation="Identity",
         use_norm=False),
    dict(kernel_size=3, stride=1, padding=1, activation="Tanh",
         use_norm=False),
]


@pytest.mark.parametrize("case", CASB_CASES)
def test_casb_matches_jax(case):
    """measured max error at most 3.3e-6 over the five cases"""
    cin, feat = 8, 16
    x = np.random.RandomState(10).randn(BATCH, 32, 32, cin).astype(np.float32)
    jmod = jblocks.CaSb(feat, **case)
    params = _np_tree(jmod.init(jax.random.PRNGKey(2), x)["params"])
    conv = params["ReflectConv_0"]["Conv_0"]
    tmod = tblocks.CaSb(cin, feat, **case)
    tmod.load_state_dict({
        "conv.weight": torch.from_numpy(np.ascontiguousarray(
            np.transpose(conv["kernel"], (3, 2, 0, 1)))),
        "conv.bias": torch.from_numpy(np.array(conv["bias"])),
    }, strict=True)
    with torch.no_grad():
        got = tmod(_nchw(x))
    _close(got, jmod.apply({"params": params}, x))


def test_bf16_blocks_run_in_bf16_with_f32_params(vae):
    """dtype=bf16 casts the input and the f32 weights to bf16 for the conv
    (as blocks.py does in JAX); IN statistics stay f32."""
    tree, _ = vae
    tnet = tnets.Encoder(BASE, dtype=torch.bfloat16)
    sd = {k[len("encoder."):]: v for k, v in params_from_jax(tree).items()
          if k.startswith("encoder.")}
    tnet.load_state_dict(sd, strict=True)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    x = _images(11)
    with torch.no_grad():
        got = tnet(_nchw(x))
    assert got.dtype == torch.bfloat16
    want = jnets.Encoder(BASE, dtype=jnp.bfloat16).apply(
        {"params": tree["encoder"]}, x)
    assert want.dtype == jnp.bfloat16
    # bf16 rounding differs between the frameworks' convs: a loose band
    np.testing.assert_allclose(_nhwc(got), np.asarray(want, np.float32),
                               atol=0.1, rtol=0.1)


def _bf16(a):
    """a rounded to bf16, held in f32 (the same input for both sides)."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)


@pytest.fixture(scope="module")
def biased_tree(vae):
    """The VAE tree with random biases in place of the initial zeros, so
    that where the bias is added in bf16 shows in the output."""
    tree, _ = vae
    rng = np.random.RandomState(13)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.randn(*a.shape).astype(np.float32) * 0.5
                         if path[-1].key == "bias" else a), tree)


# (name, JAX module, its param path in the VAE tree, port module, its
# state_dict prefix, input shape NHWC): every block kind of the generator in
# bf16, the decoder's two conv-kernel sites (U4, tail) included
S = IMAGE // 16
BF16_BLOCKS = [
    ("encoder head", lambda: jblocks.CaSb(BASE, 7, 1, 3, dtype=jnp.bfloat16),
     ("encoder", "CaSb_0"),
     lambda: tblocks.CaSb(3, BASE, 7, 1, 3, dtype=torch.bfloat16),
     "encoder.model.0.", (BATCH, IMAGE, IMAGE, 3)),
    ("encoder D1", lambda: jblocks.DBlock(2 * BASE, dtype=jnp.bfloat16),
     ("encoder", "DBlock_0"),
     lambda: tblocks.DBlock(BASE, 2 * BASE, dtype=torch.bfloat16),
     "encoder.model.1.", (BATCH, IMAGE, IMAGE, BASE)),
    ("encoder R", lambda: jblocks.RBlock(16 * BASE, dtype=jnp.bfloat16),
     ("encoder", "RBlock_0"),
     lambda: tblocks.RBlock(16 * BASE, dtype=torch.bfloat16),
     "encoder.model.5.", (BATCH, S, S, 16 * BASE)),
    ("mu conv", lambda: jblocks.LConv(LATENT, dtype=jnp.bfloat16),
     ("variational_encoder_block", "LConv_0"),
     lambda: tblocks.LConv(16 * BASE, LATENT, dtype=torch.bfloat16),
     "variational_encoder_block.muConv.", (BATCH, S, S, 16 * BASE)),
    ("decoder R", lambda: jblocks.RBlock(16 * BASE, dtype=jnp.bfloat16),
     ("decoder", "RBlock_0"),
     lambda: tblocks.RBlock(16 * BASE, dtype=torch.bfloat16),
     "decoder.model.0.", (BATCH, S, S, 16 * BASE)),
    ("decoder U1", lambda: jblocks.UBlock(8 * BASE, dtype=jnp.bfloat16),
     ("decoder", "UBlock_0"),
     lambda: tblocks.UBlock(16 * BASE, 8 * BASE, dtype=torch.bfloat16),
     "decoder.model.1.", (BATCH, S, S, 16 * BASE)),
    ("decoder U4", lambda: jblocks.UBlock(BASE, dtype=jnp.bfloat16),
     ("decoder", "UBlock_3"),
     lambda: tblocks.UBlock(2 * BASE, BASE, dtype=torch.bfloat16),
     "decoder.model.4.", (BATCH, IMAGE // 2, IMAGE // 2, 2 * BASE)),
    ("decoder tail", lambda: jblocks.CaSb(3, 7, 1, 3, activation="Identity",
                                          use_norm=False, dtype=jnp.bfloat16),
     ("decoder", "CaSb_0"),
     lambda: tblocks.CaSb(BASE, 3, 7, 1, 3, activation="Identity",
                          use_norm=False, dtype=torch.bfloat16),
     "decoder.model.5.", (BATCH, IMAGE, IMAGE, BASE)),
]


@pytest.mark.parametrize("case", BF16_BLOCKS, ids=[c[0] for c in BF16_BLOCKS])
def test_bf16_block_matches_jax_bf16_to_one_rounding(biased_tree, case):
    """Each block in bf16, on the same bf16 input and the same f32 weights,
    against the JAX block in bf16. Band: one bf16 rounding, |err| <= 2^-7
    |want| + 2^-6 (the ulp of the [2, 4) range the IN outputs and residual
    sums reach), and at most 5% of the elements differ at all: a rounding
    to bf16 moved to another place in the block changes far more (adding
    the bias before the conv's rounding, or the residual before the IN's,
    changes 27-30%). Measured over the eight blocks: max error 3.1e-2, at
    most 0.61 of the band; at most 0.03% of the elements differ."""
    _, jmod, path, tmod, prefix, shape = case
    tree = biased_tree
    x = _bf16(np.random.RandomState(12).randn(*shape))
    want = np.asarray(jmod().apply({"params": tree[path[0]][path[1]]},
                                   jnp.asarray(x, jnp.bfloat16)), np.float32)
    net = tmod()
    net.load_state_dict({k[len(prefix):]: v for k, v in
                         params_from_jax(tree).items()
                         if k.startswith(prefix)}, strict=True)
    with torch.no_grad():
        got = net(_nchw(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = _nhwc(got)
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=2 ** -6)
    assert float((got != want).mean()) <= 0.05


def test_bf16_vae_net_matches_jax_bf16_with_injected_eps(biased_tree):
    """The whole generator in bf16 against JAX's in bf16, same f32 weights
    and eps. Each block agrees to one rounding (previous test), but a
    one-ulp difference grows through 18 convs and 11 norms, so the band is
    on the relative L2 error: at most half the distance of JAX's own bf16
    output from its f32 output. Measured (Gx, mu, logvar): 3.8e-2, 1.3e-2,
    1.4e-2, against bf16-vs-f32 distances of 1.47e-1, 5.8e-2, 6.5e-2
    (ratios 0.26, 0.22, 0.22)."""
    tree = biased_tree
    x = _images(5)
    s = IMAGE // 16
    eps = np.random.RandomState(6).randn(BATCH, s, s, LATENT).astype(np.float32)

    def jax_run(dtype):
        with eps_queue([jnp.asarray(eps)]):
            out = jnets.VariationalAutoencoderNet(LATENT, BASE, dtype=dtype
                                                  ).apply(
                {"params": tree}, x, rngs={"reparam": jax.random.PRNGKey(9)})
        return [np.asarray(o, np.float32) for o in out]

    want16, want32 = jax_run(jnp.bfloat16), jax_run(jnp.float32)
    tnet = tnets.VariationalAutoencoderNet(LATENT, BASE, dtype=torch.bfloat16)
    tnet.load_state_dict(params_from_jax(tree), strict=True)
    with torch.no_grad():
        got = tnet(_nchw(x), eps=_nchw(eps))
    assert all(t.dtype == torch.bfloat16 for t in got)
    for g, w16, w32 in zip(got, want16, want32):
        g = _nhwc(g)
        assert np.isfinite(g).all()
        rel = np.linalg.norm(g - w16) / np.linalg.norm(w16)
        gap = np.linalg.norm(w16 - w32) / np.linalg.norm(w32)
        assert rel <= 0.5 * gap, (rel, gap)


def test_weight_bridge_round_trip_is_exact(vae):
    """params_from_jax loads strictly into the port, and the port's
    state_dict goes back through the JAX package's own torch importer to
    the original tree, bit for bit."""
    tree, tnet = vae
    sd = {k: v.numpy() for k, v in tnet.state_dict().items()}
    back = torch_import.vae_params(sd, "")
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(tree)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the {"G", "F"} form gets the reference's prefixes
    both = params_from_jax({"G": tree, "F": tree})
    assert set(both) == {f"G.{k}" for k in sd} | {f"F.{k}" for k in sd}
    back_g = torch_import.vae_params(
        {k: v.numpy() for k, v in both.items()}, "G.")
    for a, b in zip(jax.tree_util.tree_leaves(back_g),
                    jax.tree_util.tree_leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_weight_bridge_rejects_a_foreign_tree(vae):
    tree, _ = vae
    broken = dict(tree, encoder={k: v for k, v in tree["encoder"].items()
                                 if k != "RBlock_0"})
    with pytest.raises(KeyError, match="RBlock_0"):
        params_from_jax(broken)
    with pytest.raises(KeyError, match="networks"):
        params_from_jax({"encoder": tree["encoder"]})
