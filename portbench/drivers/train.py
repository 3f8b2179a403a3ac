"""Training traffic: a closed loop of ``Engine.train_epoch`` over the
program's own ``DataLoader``, as ``train.py`` trains, until the window
closes.

Set-up makes the cell's data tree and the program's dataset over it
(``datasets/<dataset>.py``), the loader, the task (the cell's
configuration, weights from the seed) and its ``Engine``, then drives that
one engine through its first steps by its own call and feed: three epochs
of one step each (each ``train_epoch`` call starts an epoch, as training
does), reading after the first the gradient Adam got and after the third
each parameter's change. A step at the epoch's remainder batch, if the
epoch has one, warms that shape. The window then runs ``train_epoch`` call
after call, each stopping when the window's time is up, and counts the
images of the steps it ran over the time up to the last step's metrics.

Every sample draws its augmentation from the stream
``reference.data.augment_rng`` gives it (the run's seed, the count of
``train_epoch`` calls, its dataset index), and the loader hands its index
back beside it; so the reference needs only the indices of each compared
batch, which it judges (distinct, in range), to work every sample out
again from the raw files. After the window the program is released and the
reference repeats the three steps from the same weights, samples and noise
seed.
"""

from __future__ import annotations

import gc
import math
import time
import warnings
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from portbench import check, datasets, trace, weights
from portbench.harness import sub_seed
from portbench.reference import datasets as ref_datasets
from portbench.reference.data import augment_rng
from portbench.reference.nets import F32, Precision
from portbench.reference.steps import family

CHECK_STEPS = 3
#: the key under which a sample's dataset index rides beside it
INDEX = "portbench_index"
#: the faults ``reference`` can plant, for the limits' readings and the
#: harness's tests: half of each batch left out (the mean over the rest),
#: the reconstruction weights (cycle, recon) x1.1, every generator output
#: x1.01 where it is produced
FAULTS = ("half_batch", "recon_weight", "gen_output")


class _Counting:
    """A loader that takes the indices off every batch it yields and
    records them, so the window counts the images of the steps that ran,
    not of the batch the engine fetched ahead."""

    def __init__(self, loader):
        self.loader = loader
        self.indices = []

    def __iter__(self):
        for batch in self.loader:
            self.indices.append(batch.pop(INDEX).tolist())
            yield batch

    def __len__(self):
        return len(self.loader)

    def __getattr__(self, name):
        return getattr(self.loader, name)


class _Keyed:
    """The program's dataset, each sample handed its stream by
    ``augment_rng`` (for the ``train_epoch`` call `epoch`) in place of the
    loader's, and its index returned beside it."""

    def __init__(self, base, seed: int):
        self.base, self.seed, self.epoch = base, seed, 0

    def __len__(self):
        return len(self.base)

    def get(self, idx, rng):
        item = dict(self.base.get(idx, augment_rng(self.seed, self.epoch,
                                                   idx)))
        item[INDEX] = np.asarray(idx, np.int64)
        return item


def _model_configs(cfg: dict, device):
    from vae_cyclegan_tpu_torch.config import LossConfig, ModelConfig, OptimConfig

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        cfg["compute_dtype"]]
    lam, adam = cfg["losses"], cfg["adam"]
    return dict(
        model=ModelConfig(cfg["image_size"], cfg["latent_dim"],
                          cfg["base_width"], dtype, cfg["instance_norm"]),
        optim=OptimConfig(adam["lr"], tuple(adam["betas"]), adam["eps"]),
        loss=LossConfig(lam["kl"], lam["gan"], lam["identity"],
                        lam["cycle"], lam["recon"]),
        paired=cfg["paired"], device=device)


def build_task(cfg: dict, seed: int, device):
    """The program's task for `cfg` with the run's weights loaded."""
    from vae_cyclegan_tpu_torch.models.tasks import create_task

    task = create_task(cfg["architecture"], **_model_configs(cfg, device))
    task.load_state_dict(weights.make(cfg, sub_seed(seed, 0), device))
    return task


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    names = list(tensors)
    if not names:
        return {}
    norms = torch.stack([torch.linalg.vector_norm(tensors[k].float())
                         for k in names]).cpu().tolist()
    return dict(zip(names, norms))


class Cell:
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 scratch: Path, log=print):
        self.cell, self.cfg, self.seed = cell, cfg, seed
        self.p = cell["params"]
        self.device = torch.device(device)
        self.scratch, self.log = scratch, log
        self.program: Dict = {}
        self.keep_grad_vec = False

    # -- set-up -------------------------------------------------------------

    def _dataset(self):
        base, self.files = datasets.module(self.p["dataset"]).make(
            self.scratch / "data", self.p, self.cfg, sub_seed(self.seed, 1),
            self.device)
        return _Keyed(base, self.seed)

    def _epoch(self, loader, **kw):
        """One ``train_epoch`` call, its samples on the next epoch's
        streams."""
        self.dataset.epoch = self.epochs
        self.epochs += 1
        return self.engine.train_epoch(loader, progress=False, **kw)

    def _loader(self, dataset, batch):
        from vae_cyclegan_tpu_torch.data import DataLoader

        return DataLoader(dataset, batch, shuffle=True, seed=self.seed,
                          num_workers=self.p["num_workers"])

    def setup(self) -> None:
        from vae_cyclegan_tpu_torch.engine import Engine

        t = time.perf_counter()
        self.dataset = self._dataset()
        self.epochs = 0
        batch = self.p["batch_size"]
        self.loader = _Counting(self._loader(self.dataset, batch))
        self.log(f"set-up: data tree {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        self.task = build_task(self.cfg, self.seed, self.device)
        self.engine = Engine(self.task, seed=sub_seed(self.seed, 2))
        self.log(f"set-up: task {time.perf_counter() - t:.2f} s")
        t = time.perf_counter()
        losses, self.check_indices = [], []
        for step in range(CHECK_STEPS):
            self.loader.indices.clear()
            _, avg, _ = self._epoch(self.loader, should_stop=lambda: True)
            self.check_indices.append(self.loader.indices[0])
            losses.append((avg.get("G_loss", math.nan),
                           avg.get("D_loss", math.nan)))
            if step == 0:
                self.program.update(self._first_grads(), metrics=avg)
        self.program["losses"] = losses
        self.program["change"] = self._changes()
        self.log(f"set-up: {CHECK_STEPS} first steps {time.perf_counter() - t:.2f} s")
        rest = len(self.dataset) % batch
        if rest:
            from vae_cyclegan_tpu_torch.data import DataLoader, Subset

            self._epoch(_Counting(DataLoader(Subset(self.dataset, range(rest)),
                                             rest, num_workers=self.p[
                                                 "num_workers"])))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _named_params(self):
        return dict(self.task.nets.named_parameters())

    def _first_grads(self) -> dict:
        """The first gradient as Adam got it, m_1 / (1 - beta1): its leaf
        norms ("grad"), with ``keep_grad_vec`` (the limits' readings) also
        the leaves themselves on the host ("grad_vec")."""
        beta1 = self.cfg["adam"]["betas"][0]
        moments = {}
        for name, p in self._named_params().items():
            for opt in self.task.optimizers().values():
                state = opt.state.get(p)
                if state:
                    moments[name] = state["exp_avg"] / (1.0 - beta1)
        out = {"grad": _leaf_norms(moments)}
        if self.keep_grad_vec:
            out["grad_vec"] = {k: v.cpu() for k, v in moments.items()}
        return out

    def _changes(self) -> Dict[str, float]:
        start = weights.make(self.cfg, sub_seed(self.seed, 0), self.device)
        return _leaf_norms({k: p.detach() - start[k]
                            for k, p in self._named_params().items()})

    # -- window -------------------------------------------------------------

    def window(self, seconds: float) -> dict:
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        steps = images = 0
        host = h2d = nan = 0.0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            self.loader.indices.clear()
            ran = [0]

            def stop():
                ran[0] += 1
                return time.perf_counter() >= deadline

            _, avg, _ = self._epoch(self.loader, should_stop=stop)
            n = ran[0]
            ph = self.engine.epoch_phases
            steps += n
            images += sum(map(len, self.loader.indices[:n]))
            host += ph["host_ms_per_batch"] * n
            h2d += ph["h2d_wait_ms_per_batch"] * n
            nan += avg.get("nan_detected", 0.0) * n
            if time.perf_counter() >= deadline:
                break
        if cuda:
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        self.log(f"window: {steps} steps, {images} images in {elapsed:.4f} s")
        return {"attempted": steps, "failed": int(round(nan)),
                "images_per_s": images / elapsed,
                "s_per_unit": elapsed / steps,
                "metrics": {"train_images_per_s": images / elapsed},
                "host_ms_per_batch": host / steps,
                "h2d_wait_ms_per_batch": h2d / steps,
                "peak_bytes": (torch.cuda.max_memory_allocated(self.device)
                               if cuda else 0)}

    # -- trace --------------------------------------------------------------

    def trace(self):
        """Two spans of ``trace_steps`` steps inside an epoch (after
        ``trace_after`` steps of it): the device activity alone, with the
        synchronising calls counted, then with the host operators and their
        shapes; (span, op span, syncs)."""
        after, k = self.p["trace_after"], self.p["trace_steps"]
        cuda = self.device.type == "cuda"
        syncs = []

        def run(control, count_syncs):
            ran = [0]
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("ignore")

                def stop():
                    ran[0] += 1
                    if ran[0] == after:
                        if cuda:
                            torch.cuda.synchronize(self.device)
                            if count_syncs:
                                torch.cuda.set_sync_debug_mode("warn")
                        caught.clear()
                        warnings.simplefilter("always")
                        control.open()
                    elif ran[0] == after + k:
                        if cuda and count_syncs:
                            torch.cuda.set_sync_debug_mode("default")
                        control.close()
                        if cuda and count_syncs:
                            syncs.append(sum("synchroniz" in str(w.message)
                                             for w in caught))
                        return True
                    return False

                self._epoch(self.loader, should_stop=stop)
            return k

        span = trace.profile_span(lambda c: run(c, True), self.scratch,
                                  self.log)
        op_span = trace.profile_span(lambda c: run(c, False), self.scratch,
                                     self.log, with_ops=True)
        return span, op_span, (syncs[-1] if syncs else None)

    # -- the comparison -----------------------------------------------------

    def release(self) -> None:
        self.loader.close()
        del self.engine, self.task, self.loader
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _batches(self):
        """The reference's own (x, y) NCHW f32 batches of the check steps,
        from the indices the program's loader gave each; None for a step
        whose indices are not distinct dataset indices."""
        ref = ref_datasets.module(self.p["dataset"])
        n = len(self.dataset)
        for epoch, idx in enumerate(self.check_indices):
            if len(set(idx)) != len(idx) or not all(0 <= i < n for i in idx):
                yield None
                continue
            yield ref.batch(self.files, [(i, augment_rng(self.seed, epoch, i))
                                         for i in idx],
                            self.p, self.cfg, self.device)

    def reference(self, prec: Precision = F32, fault: str = None) -> dict:
        """The reference's three steps: {"losses", "metrics" (the first
        step's), "grad", "change", with ``keep_grad_vec`` "grad_vec"}, or
        {} where the program's loader gave a batch no sample can make.
        `fault` plants one of ``FAULTS`` (the limits' readings, the
        harness's tests)."""
        cuda = self.device.type == "cuda"
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
        if cuda:
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cudnn.benchmark = True
        try:
            cfg = self.cfg
            if fault == "recon_weight":
                lam = cfg["losses"]
                cfg = {**cfg, "losses": {**lam, "cycle": 1.1 * lam["cycle"],
                                         "recon": 1.1 * lam["recon"]}}
            fam = family(cfg, prec, self.device)
            if fault == "gen_output":
                for key in fam.gen_keys:
                    fam.nets[key].register_forward_hook(
                        lambda m, args, out: (out[0] * 1.01, *out[1:]))
            fam.load(weights.make(self.cfg, sub_seed(self.seed, 0),
                                  self.device))
            gen = torch.Generator(self.device).manual_seed(
                sub_seed(self.seed, 2))
            names = [n for n, _ in fam.nets.named_parameters()]
            pos = {id(p): n for n, p in fam.nets.named_parameters()}
            losses, grad, grad_vec, first = [], None, None, None
            for xy in self._batches():
                if xy is None:
                    return {}
                x, y = xy
                if fault == "half_batch":
                    x, y = x[:max(1, len(x) // 2)], y[:max(1, len(y) // 2)]
                metrics, gg, dg = fam.step(x, y, gen)
                losses.append((metrics["G_loss"],
                               metrics.get("D_loss", math.nan)))
                if grad is None:
                    first = metrics
                    grad_vec = {pos[id(p)]: t for p, t in zip(
                        fam.gen_params + fam.disc_params, gg + dg)}
                    grad = _leaf_norms(grad_vec)
                    grad_vec = ({k: v.cpu() for k, v in grad_vec.items()}
                                if self.keep_grad_vec else None)
            start = weights.make(self.cfg, sub_seed(self.seed, 0), self.device)
            params = dict(fam.nets.named_parameters())
            change = _leaf_norms({k: params[k].detach() - start[k]
                                  for k in names})
            out = {"losses": losses, "metrics": first, "grad": grad,
                   "change": change}
            if grad_vec is not None:
                out["grad_vec"] = grad_vec
            return out
        finally:
            if cuda:
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32,
                 torch.backends.cudnn.benchmark) = tf32

    def compare(self, wanted) -> Dict[str, float]:
        return check.training_numbers(self.program, self.reference(), wanted)
