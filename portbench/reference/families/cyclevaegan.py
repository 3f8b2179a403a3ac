"""The Cycle-VAE-GAN training step (``Networks.py``'s ``CycleVAEGAN``)."""

from __future__ import annotations

from portbench.reference.nets import F32
from portbench.reference.steps import Family, kl, l1, mse


class CycleVAEGAN(Family):
    """G: X -> Y and F: Y -> X (variational), DX and DY. Per step six
    generator passes G(x), G(y), F(G(x)), F(y), F(x), G(F(y)) and eight
    discriminator passes. G_loss = 10 cycle + (fake LSGAN terms) + 1e-5 KL
    [+ 5 identity when paired]; D_loss = LSGAN on x and y."""

    gen_keys = ("F", "G")
    disc_keys = ("DX", "DY")

    def __init__(self, cfg, prec=F32, device="cpu"):
        super().__init__(cfg, prec, device)
        self.paired = cfg["paired"]

    def generator_loss(self, x, y, generator, parts):
        G, F_, DX, DY = (self.nets[k] for k in ("G", "F", "DX", "DY"))
        Gx, mu_x, lv_x = G(x, generator)
        Gy, _, _ = G(y, generator)
        FGx, mu_fgx, lv_fgx = F_(Gx, generator)
        Fy, mu_y, lv_y = F_(y, generator)
        Fx, _, _ = F_(x, generator)
        GFy, mu_gfy, lv_gfy = G(Fy, generator)
        DYGx, DXFy, DXx, DYy = DY(Gx), DX(Fy), DX(x), DY(y)
        lam = self.lam
        parts.update(
            loss_cycle=l1(FGx, x) + l1(GFy, y),
            loss_kl=(kl(mu_x, lv_x) + kl(mu_fgx, lv_fgx) + kl(mu_y, lv_y)
                     + kl(mu_gfy, lv_gfy)),
            loss_gan_g_x_real=mse(DXx, 0.0), loss_gan_g_x_fake=mse(DXFy, 1.0),
            loss_gan_g_y_real=mse(DYy, 0.0), loss_gan_g_y_fake=mse(DYGx, 1.0))
        loss = (lam["cycle"] * parts["loss_cycle"]
                + lam["gan"] * (parts["loss_gan_g_x_fake"]
                                + parts["loss_gan_g_y_fake"])
                + lam["kl"] * parts["loss_kl"])
        if self.paired:
            parts["loss_identity"] = l1(Fx, x) + l1(Gy, y)
            loss = loss + lam["identity"] * parts["loss_identity"]
        return loss, (Gx.detach(), Fy.detach())

    def discriminator_loss(self, x, y, keep, parts):
        Gx, Fy = keep
        DX, DY = self.nets["DX"], self.nets["DY"]
        DYGx, DXFy, DXx, DYy = DY(Gx), DX(Fy), DX(x), DY(y)
        parts.update(
            D_loss_x_real=mse(DXx, 1.0), D_loss_x_fake=mse(DXFy, 0.0),
            D_loss_y_real=mse(DYy, 1.0), D_loss_y_fake=mse(DYGx, 0.0),
            d_x_real_mean=DXx.mean(), d_x_fake_mean=DXFy.mean(),
            d_y_real_mean=DYy.mean(), d_y_fake_mean=DYGx.mean())
        return ((parts["D_loss_x_real"] + parts["D_loss_x_fake"])
                + (parts["D_loss_y_real"] + parts["D_loss_y_fake"]))


FAMILY = CycleVAEGAN
