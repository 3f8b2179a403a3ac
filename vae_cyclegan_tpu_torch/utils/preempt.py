"""Preemption-safe shutdown for the training driver.

TPU VMs announce maintenance/preemption by delivering SIGTERM with a
short grace window; the reference's only recovery story is the periodic
checkpoint (reference train.py:573-575), so an eviction loses up to
`save_freq` epochs of work. `GracefulShutdown` converts the FIRST
SIGTERM/SIGINT into a request flag the epoch loop polls at step
boundaries: the driver finishes the in-flight step, saves a resumable
`checkpoint_preempt/` (full TrainState: params, both optimizer states,
spectral stats, rng), and exits 0. A SECOND signal aborts immediately
(the default handler is restored and the signal re-raised), so a stuck
save can still be killed.

The interrupted epoch is saved as `epoch - 1` in the checkpoint
metadata: `--resume` re-runs the whole interrupted epoch, which keeps
the epoch-indexed TensorBoard schema and the save/best cadence exact at
the cost of re-doing at most one epoch of steps.

Counterpart of ``vae_cyclegan_tpu/utils/preempt.py``, copied; the port's
``Engine.train_epoch`` polls it through `should_stop`, and its checkpoint
holds the task's weights, both Adam states and the training generator.

In a process group the signal may reach one rank only (a host's own
eviction notice) or every rank at different steps. ``AgreedStop`` makes
it one decision: polled at each step boundary, it takes the maximum of
every rank's flag in one all_reduce over a gloo group (host memory: the
poll does not wait for the card), so every rank stops after the same step
and the primary rank saves the checkpoint.
"""

from __future__ import annotations

import signal
from typing import Iterable

import torch


class GracefulShutdown:
    """Polls as a zero-arg callable; install()/uninstall() manage handlers."""

    def __init__(self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._signals = tuple(signals)
        self._prev: dict = {}

    def install(self) -> "GracefulShutdown":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._handle)
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _handle(self, signum, frame) -> None:
        if self.requested:
            # Second signal: hand back to the default/previous behavior —
            # restore it and re-deliver so "kill again" really kills.
            import os

            prev = self._prev.get(signum, signal.SIG_DFL)
            signal.signal(signum, prev)
            os.kill(os.getpid(), signum)
            return
        self.requested = True
        name = signal.Signals(signum).name
        print(
            f"\n{name} received: finishing the current step, saving a "
            f"preemption checkpoint, then exiting cleanly "
            f"(send {name} again to abort immediately)",
            flush=True,
        )

    def __call__(self) -> bool:
        return self.requested


class AgreedStop:
    """`local` (a ``GracefulShutdown``) agreed across the ranks of `group`:
    each poll all_reduces the ranks' flags (their maximum), and once any
    rank has asked, every rank reads ``requested`` True from that step on.
    Every rank must poll at the same steps."""

    def __init__(self, local: GracefulShutdown, group):
        self.local = local
        self.group = group
        self.requested = False

    def __call__(self) -> bool:
        if not self.requested:
            import torch.distributed as dist

            flag = torch.tensor([int(self.local.requested)],
                                dtype=torch.int32)
            dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=self.group)
            self.requested = bool(flag.item())
        return self.requested
