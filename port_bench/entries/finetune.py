"""Entry `finetune`: the FiLM fine-tune through `Trainer.train_steps`, one
optimizer step (K = 1) per call, as `Trainer.train` runs it, over a pool of
samples resident on the device (a `train_pool` mix).

Set-up builds one `Trainer`, loads the seeded weights, starts its state,
makes the pool, and drives the trainer through the check's first steps
(pool samples 0, 1, 2, all different) with the window's own call; the same
trainer and state then run the window, cycling the pool.  The pool's
targets are stepped by the plain reference standing for the tuned model
the fine-tune moves toward: its trainable leaves moved from the starting
ones toward a second draw from the seed by the mix's `target_shift` (0:
the starting model, 1: the second draw); the seconds that takes are the
reference's, and are not counted in `setup_s`.
The check compares those first steps with the plain fp32 reference after
the window: each step's loss, each trainable leaf's first gradient (as
Adam holds it after one step: mu / (1 - b1)) and each leaf's change over
the steps, by the gap of norms.
"""

from __future__ import annotations

import gc
import statistics
import time

import torch

from port_bench.harness import program, traffic

B1 = 0.9


class Entry:
    unit = "samples"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.check_steps = mix["check_steps"]
        self.batch = mix["batch"]
        self.reference_s = 0.0  # set-up seconds spent in the reference
        self.reference_losses = {}  # the reference's and the control's, by name

    def flops_per_unit(self) -> float:
        """Model FLOPs of one training sample's optimizer step."""
        return program.family(self.cfg).train_flops(self.cfg, self.mix["multi_step_training"])

    # ---------------------------------------------------------------- set-up

    def setup(self):
        from msfno_torch.config import finetune_train_config
        from msfno_torch.training.trainer import Trainer

        mix = self.mix
        tcfg = finetune_train_config(multi_step_training=mix["multi_step_training"],
                                     batch_size=mix["batch"],
                                     learning_rate=mix["learning_rate"])
        self.trainer = Trainer(program.program_config(self.cfg), tcfg, device=self.device)
        weights = program.seeded_weights(self.cfg, self.seed, self.device)
        self.trainer.model.load_state_dict(weights)
        del weights
        self.state = self.trainer.init_state()
        self.sync()
        t = time.perf_counter()
        self.era5, self.sst = self.pool()
        self.sync()
        self.reference_s = time.perf_counter() - t
        if self.device.type == "cuda":
            # the peak is the program's: the reference that made the targets
            # is gone
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)
        theta0 = {n: p.detach().float().clone() for n, p in self.state.trainable.items()}
        losses, self.grad0 = [], None
        for k in range(self.check_steps):
            self.state, m = self.step(k)
            losses.append(m["loss"])
            if k == 0:
                mu = self.state.opt_state["inner"]["mu"]
                self.grad0 = {n: (mu[n] / (1.0 - B1)).clone() for n in theta0}
        self.losses = [float(x.reshape(-1)[0]) for x in losses]
        self.change = {n: p.detach().float() - theta0[n]
                       for n, p in self.state.trainable.items()}
        self.next = self.check_steps

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def pool(self, count: int | None = None):
        """The mix's samples (the first `count`), their targets stepped by
        the plain reference with its trainable leaves moved by the mix's
        `target_shift` toward a second draw (made for the purpose and
        freed)."""
        net = program.reference_net(self.cfg, self.seed, self.device)
        shift = self.mix["target_shift"]
        if shift:
            drawn = program.seeded_weights(self.cfg, self.seed, self.device, tag="targets")
            with torch.no_grad():
                for n, p in program.family(self.cfg).trainable(net).items():
                    p.add_(drawn[n] - p, alpha=shift)
            del drawn
        gen = traffic.generator(self.mix)
        pool = gen.make(self.mix, self.cfg, self.seed, self.device, net, count)
        del net
        gc.collect()
        return pool

    def step(self, k: int):
        i = k % self.era5.shape[0]
        return self.trainer.train_steps(self.state, self.era5[i:i + 1], self.sst[i:i + 1])

    # ---------------------------------------------------------------- window

    def window(self, seconds: float, spans: dict, timing) -> dict:
        """Steps until `seconds` of host time have passed; a step counts
        when its event, recorded after it, completed inside the window."""
        start = timing.event()
        t0 = time.perf_counter()
        events, losses, enqueue = [], [], 0.0
        while time.perf_counter() - t0 < seconds:
            h = time.perf_counter()
            self.state, m = self.step(self.next)
            enqueue += time.perf_counter() - h
            self.next += 1
            events.append(timing.event())
            losses.append(m["loss"])
        timing.sync()
        done = [timing.elapsed(start, ev) for ev in events]
        finished = sum(1 for t in done if t <= seconds)
        bad = sum(1 for x in losses if not torch.isfinite(x).all())
        spans["host_enqueue_s"] = enqueue
        spans["steps"] = len(events)
        b = self.mix["batch"]
        return {"attempted": len(events) * b, "failed": bad * b,
                "units_done": finished * b, "units_traced": len(events) * b}

    def release(self):
        """Free the program's state, keeping its readings of the check's
        steps (`readings`)."""
        self.prog = (self.losses, {n: g.cpu() for n, g in self.grad0.items()},
                     {n: c.cpu() for n, c in self.change.items()})
        del self.trainer, self.state, self.era5, self.sst, self.grad0, self.change
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self):
        return self.prog

    # ----------------------------------------------------------------- check

    def reference(self, control: bool = False):
        """(losses, first gradients, changes) of the plain reference over
        the check's steps; with `control`, the configuration's control:
        the reference a precision below the configuration's."""
        fam = program.family(self.cfg)
        era5, sst = self.pool(self.check_steps)
        batches = [(era5[k % era5.shape[0]], sst[k % era5.shape[0]])
                   for k in range(self.check_steps)]
        net = program.reference_net(self.cfg, self.seed, self.device)
        theta0 = {n: p.detach().clone() for n, p in fam.trainable(net).items()}
        with program.control(self.cfg, net, self.cfg["control"] if control else None):
            losses, grads, theta = fam.train(net, batches, self.mix["multi_step_training"],
                                             self.mix["learning_rate"])
        self.reference_losses["control" if control else "reference"] = losses
        out = (losses, {n: g.cpu() for n, g in grads.items()},
               {n: (theta[n] - theta0[n]).cpu() for n in theta})
        del net, era5, sst, batches
        gc.collect()
        return out


def leaf_gaps(prog, ref) -> tuple[dict, dict]:
    """Per trainable leaf, the gap of norms of the first gradient and of the
    change, each as a share of the larger of that leaf's reference norm and
    the median leaf's.  Leaves whose reference gradient is nought to
    rounding (under a thousandth of the median leaf's) move under Adam by
    round-off alone and are left out of the change."""
    (_, p_grad, p_change), (_, r_grad, r_change) = prog, ref
    gn = {n: float(g.norm()) for n, g in r_grad.items()}
    med_g = statistics.median(gn.values())
    grad = {n: abs(float(p_grad[n].norm()) - gn[n]) / max(gn[n], med_g) for n in gn}
    moved = [n for n in gn if gn[n] >= 1e-3 * med_g]
    cn = {n: float(r_change[n].norm()) for n in moved}
    med_c = statistics.median(cn.values())
    change = {n: abs(float(p_change[n].norm()) - cn[n]) / max(cn[n], med_c) for n in moved}
    return grad, change


def compare(prog, ref) -> dict:
    """The numbers compared: the loss gap (largest over the steps, as a
    share of the reference's loss), and the worst leaf's gaps of the first
    gradient and of the change (`leaf_gaps`)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog[0], ref[0]))
    grad, change = leaf_gaps(prog, ref)
    return {"loss_gap": loss, "grad_gap": max(grad.values()),
            "change_gap": max(change.values())}
