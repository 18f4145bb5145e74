"""The harness with the timed path broken underneath: a run at a small size on
the CPU (the look for a card skipped) sees ``correct`` come out false for each
fault its cell can have, and true without one. One card: no exchange between
chips to leave out."""

import pytest
import torch
from _small import run_small


def _train_fault(kind):
    def patch(driver):
        init, step = driver.Program.__init__, driver.Program.step

        def new_init(self, *a, **k):
            init(self, *a, **k)
            tr = self.trainer
            if kind not in ("unchanged", "disc_unchanged", "leaf_altered"):
                return
            opt = tr.disc_optimizer if kind == "disc_unchanged" else tr.optimizer
            opt_step = opt.step

            def broken_step(*aa, **kk):
                if kind in ("unchanged", "disc_unchanged"):
                    return None  # the step leaves the network's state as it was
                p = next(iter(tr.generator.parameters()))
                p.grad.mul_(2.0)  # one leaf's update altered where it is made
                return opt_step(*aa, **kk)

            opt.step = broken_step

        def half_step(self, host_batch, spans):
            n = host_batch["input"].shape[0] // 2
            return step(self, {k: v[:n] for k, v in host_batch.items()}, spans)

        def sn_frozen_step(self, host_batch, spans):
            sn = self.trainer.sn_state  # the spectral state never advances
            m = step(self, host_batch, spans)
            self.trainer.sn_state = sn
            return m

        driver.Program.__init__ = new_init
        if kind == "half_batch":
            driver.Program.step = half_step
        if kind == "sn_unchanged":
            driver.Program.step = sn_frozen_step
    return patch


def _serve_fault(kind):
    def patch(driver):
        init = driver.Program.__init__

        def new_init(self, *a, **k):
            init(self, *a, **k)
            forward = self.generator.forward

            def broken(x, mask, **kw):
                occ, sdf, col, sem = forward(x, mask, **kw)
                if kind == "window_altered":  # the first window of every batch
                    sdf = sdf.clone()
                    sdf[0] = -sdf[0]
                if kind == "half_batch":
                    keep = max(1, x.shape[0] // 2)
                    occ = torch.cat([occ[:keep], torch.full_like(occ[keep:], -10.0)])
                return occ, sdf, col, sem

            self.generator.forward = broken

        driver.Program.__init__ = new_init
    return patch


def test_sound_runs_are_correct():
    for w in ("train-full-b2", "serve-chunked"):
        r = run_small(w, seconds=0.5)
        assert r["correct"] is True, r["compared"]


@pytest.mark.parametrize("kind", ["unchanged", "half_batch", "leaf_altered", "disc_unchanged",
                                  "sn_unchanged"])
def test_training_faults_come_out_not_correct(kind):
    r = run_small("train-full-b2", seconds=0.5, patch=_train_fault(kind))
    assert r["correct"] is False, r["compared"]


@pytest.mark.parametrize("kind", ["window_altered", "half_batch"])
def test_serving_faults_come_out_not_correct(kind):
    r = run_small("serve-chunked", seconds=0.5, patch=_serve_fault(kind))
    assert r["correct"] is False, r["compared"]
