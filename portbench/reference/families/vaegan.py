"""The VAE-GAN training step (``Networks.py``'s ``VAEGAN``)."""

from __future__ import annotations

from portbench.reference.steps import Family, kl, l1, mse


class VAEGAN(Family):
    """G (variational) and D, paired. G_loss = L1(Gx, y) + LSGAN(Dy -> 0,
    DGx -> 1) + 5 L1(Gy, y) + 1e-5 KL; D_loss = LSGAN on the detached Gx,
    D rerun on the generator step's power-iteration vectors."""

    gen_keys = ("G",)
    disc_keys = ("D",)

    def generator_loss(self, x, y, generator, parts):
        G, D = self.nets["G"], self.nets["D"]
        Gx, mu, logvar = G(x, generator)
        Gy, _, _ = G(y, generator)
        sp0 = D.spectral_state()
        DGx = D(Gx)
        sp1 = D.spectral_state()
        Dy = D(y)
        sp2 = D.spectral_state()
        lam = self.lam
        parts.update(loss_trans=l1(Gx, y), loss_gan_real=mse(Dy, 0.0),
                     loss_gan_fake=mse(DGx, 1.0), loss_identity=l1(Gy, y),
                     loss_kl=kl(mu, logvar))
        loss = (lam["recon"] * parts["loss_trans"]
                + lam["gan"] * (parts["loss_gan_real"] + parts["loss_gan_fake"])
                + lam["identity"] * parts["loss_identity"]
                + lam["kl"] * parts["loss_kl"])
        return loss, (Gx.detach(), (sp0, sp1, sp2))

    def discriminator_loss(self, x, y, keep, parts):
        Gx, (sp0, sp1, sp2) = keep
        D = self.nets["D"]
        D.set_spectral_state(sp0)
        DGx = D(Gx)
        D.set_spectral_state(sp1)
        Dy = D(y)
        D.set_spectral_state(sp2)
        parts.update(loss_gan_disc_real=mse(Dy, 1.0),
                     loss_gan_disc_fake=mse(DGx, 0.0))
        return parts["loss_gan_disc_real"] + parts["loss_gan_disc_fake"]


FAMILY = VAEGAN
