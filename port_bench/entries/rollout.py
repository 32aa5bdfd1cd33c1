"""Entry `rollout`: forecasts back to back through the serving wrapper's
`running` (`ModelWrapper.running`: the rollout with its one-step-behind
fetch of the collected channels), a batch of ensemble members each.

Set-up builds the wrapper of the configuration's registry entry, loads the
seeded weights (stored in the served dtype with `serving_params` where the
configuration serves bf16), makes the mix's pool of initial states and
SST series on the host, and warms the path with a two-step forecast.  The
window consumes fields until its seconds have passed, starting a new
forecast from the pool whenever one ends.  The check compares with the
plain fp32 reference, after the window, the window's first forecast: one
member, drawn from the seed, at every step delivered, and every member at
the first step; the number compared is the largest relative L2 gap of a
delivered field.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch

from port_bench.harness import program, traffic
from port_bench.harness.common import derive_seed, rel_l2


class Entry:
    unit = "member-steps"

    def __init__(self, cfg: dict, mix: dict, seed: int, device):
        self.cfg, self.mix, self.seed, self.device = cfg, mix, seed, device
        self.gen = traffic.generator(mix)
        self.steps = self.gen.rollout_steps(mix)
        self.member = int(derive_seed(seed, "checked member") % mix["members"])
        self.batch = mix["members"]
        self.reference_s = 0.0  # set-up seconds spent in the reference: none

    def flops_per_unit(self) -> float:
        """Model FLOPs of one member-step: a forward."""
        return program.family(self.cfg).forward_flops(self.cfg)

    def setup(self):
        from msfno_torch.models.registry import get_model

        model_type, version = self.cfg["program"]["model"]
        self.wrapper = get_model(model_type, version, cfg=program.program_config(self.cfg),
                                 device=self.device)
        weights = program.seeded_weights(self.cfg, self.seed, self.device)
        self.wrapper.module.load_state_dict(weights)
        del weights
        if self.cfg["served_dtype"] == "bfloat16":
            from msfno_torch.inference.rollout import serving_params

            serving_params(self.wrapper.module)
        order = self.wrapper.ordering
        self.channels = [order.index(name) for name in self.mix["collect_channels"]]
        self.pool = [self.gen.forecast(self.mix, self.cfg, self.seed, f, self.device)
                     for f in range(self.mix["initial_states"])]
        x0, series = self.pool[0]
        for _ in self.forecast(x0, series, lead_time_h=2 * self.mix["step_hours"]):
            pass

    def forecast(self, x0, series, lead_time_h=None):
        return self.wrapper.running(
            x0, lead_time_h=lead_time_h or self.mix["lead_time_h"],
            sst_seq=self.gen.sst_windows(self.mix, self.cfg, series),
            collect_channels=self.channels)

    def window(self, seconds: float, spans: dict, timing) -> dict:
        """Fields until `seconds` of host time have passed; a field counts
        when it reached this consumer inside them.  An event on the compute
        stream at each delivery times the intervals between fields on the
        device's clock."""
        b = self.mix["members"]
        hooks, marks = [], []
        gen = getattr(self.wrapper.module, "film_gen", None)
        if spans.get("trace") and gen is not None:
            # the benchmark's span around the program's FiLM generator
            hooks = [gen.register_forward_pre_hook(lambda *_: marks.append(timing.event())),
                     gen.register_forward_hook(lambda *_: marks.append(timing.event()))]
        t0 = time.perf_counter()
        events, delivered, bad, f = [], 0, 0, 0
        self.kept, self.first = [], None
        done = False
        while not done:
            x0, series = self.pool[f % len(self.pool)]
            it = self.forecast(x0, series)
            for k, field in enumerate(it):
                if time.perf_counter() - t0 >= seconds:
                    done = True
                    break
                events.append(timing.event())
                delivered += 1
                # a field that went non-finite anywhere is non-finite on a
                # coarse sample of its grid
                bad += int(not np.isfinite(field[:, ::8, ::8]).all())
                if f == 0:
                    self.kept.append(field[self.member].copy())
                    if k == 0:
                        self.first = field.copy()
            it.close()
            f += 1
        timing.sync()
        for h in hooks:
            h.remove()
        if marks:
            spans["film_gen_s"] = sum(timing.elapsed(a, b_)
                                      for a, b_ in zip(marks[::2], marks[1::2]))
        ms = [timing.elapsed(a, b_) * 1e3 for a, b_ in zip(events[:-1], events[1:])]
        spans["steps"] = delivered
        spans["step_intervals_ms"] = ms
        return {"attempted": delivered * b, "failed": bad * b, "units_done": delivered * b,
                "units_traced": delivered * b}

    def release(self):
        del self.wrapper, self.pool
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def readings(self):
        return self.first, self.kept

    def reference(self, control: bool = False):
        """The reference's fields of the checked forecast: every member at
        the first step, the checked member at every delivered step (with
        SST where the configuration is filmed).  The control computes them
        a precision below the configuration's (`control` of its file:
        float8 operands, or TF32 products)."""
        net = program.reference_net(self.cfg, self.seed, self.device)
        x0, series = self.gen.forecast(self.mix, self.cfg, self.seed, 0, self.device)
        windows = self.gen.sst_windows(self.mix, self.cfg, series)
        idx = torch.tensor(self.channels, device=self.device)

        def step(state, i, members):
            if windows is None:
                return net(state)
            sst = torch.as_tensor(np.ascontiguousarray(windows[i][members]), device=self.device)
            return net(state, sst)

        with program.control(self.cfg, net, self.cfg["control"] if control else None), \
                torch.no_grad():
            x = torch.as_tensor(x0, device=self.device)
            first = step(x, 0, slice(None))[..., idx].cpu().numpy()
            state = x[self.member:self.member + 1]
            fields = []
            for i in range(len(self.kept)):
                state = step(state, i, slice(self.member, self.member + 1))
                fields.append(state[0][..., idx].cpu().numpy())
        del net
        gc.collect()
        return first, fields


def compare(prog, ref) -> dict:
    """The largest relative L2 gap of a delivered field: the checked member
    over the forecast, every member at the first step."""
    (p_first, p_fields), (r_first, r_fields) = prog, ref
    gaps = [rel_l2(p, r) for p, r in zip(p_fields, r_fields)]
    gaps += [rel_l2(p_first[m], r_first[m]) for m in range(r_first.shape[0])]
    return {"field_gap": max(gaps)}
