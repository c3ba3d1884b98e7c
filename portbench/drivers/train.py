"""Training as traffic: calls of the program's autograd epoch engine
(``train.make_epoch_fn``, each step one CUDA-graph replay) queued back to
back, each call's losses read one call late, as ``train.fit`` drives it.

Set-up builds the engine with the configuration's loss (the thesis's
PINN FPE loss), optimizer and data, draws the net from the seed as
torch.nn.Linear initialises it, and drives that same engine through its
first epoch (a call with one active epoch, which also captures the step),
whose outputs the reference recomputes after the window: the epoch's mean
loss and loss terms, Adam's moments and the parameters' change (the
start).  The window then continues from epoch 1 with full calls of
``epochs_per_call`` epochs.  One of its calls, k, drawn from the seed
among ``check_calls``, is judged too: the state handed to it is kept, and
after the window the reference follows its first ``check_epochs`` epochs
from that state and compares each epoch's mean loss and terms as the call
returned them; the optimizer's step count must advance by exactly the
call's steps.  The data: the linear problem's fixed training set (x from
the prior, y = f(x), ``dataset_size`` x ``train_size`` rows) with fresh
noise each epoch, or scatterometry's fresh simulation of 8 batches an
epoch through the surrogate.  Traffic parameters: ``check_calls`` ([first,
stop) calls of the window), ``check_epochs``, ``trace_units``.
"""

from __future__ import annotations

import math
import time

import torch

from .. import common, flops
from ..common import Check
from ..reference import linear as ref_linear, scatterometry as ref_scat, training as ref_train
from ..reference.precision import REFERENCE


class Driver:
    def __init__(self, cell: common.Cell, spans: common.Spans):
        self.cell, self.spans = cell, spans
        cfg = cell.config
        self.epc, self.batch = int(cfg["epochs_per_call"]), int(cfg["batch_size"])
        if cfg["problem"] == "linear":
            self.n_train = int(int(cfg["dataset_size"]) * float(cfg["train_size"]))
            self.steps_per_epoch = self.n_train // self.batch
        else:
            self.steps_per_epoch = int(cfg["batches_per_epoch"])
        self.train_seed = common.derive(cell.seed, 7) % 2**31
        lo, hi = cell.traffic["check_calls"]
        self.check_call = lo + common.derive(cell.seed, 8) % (hi - lo)
        self.check_epochs = min(int(cell.traffic["check_epochs"]), self.epc)
        self.losses, self.checked = [], None

    def _program(self):
        from dmip_tpu_torch import data, train
        from dmip_tpu_torch.models.diffusion import CDE, LossConfig

        cfg, dev = self.cell.config, self.cell.device
        model = CDE(xdim=cfg["xdim"], ydim=cfg["ydim"], hidden_layers=tuple(cfg["hidden_layers"]))
        loss_cfg = LossConfig(name=cfg["loss_fn"], lam=float(cfg["lam"]), lam2=float(cfg["lam2"]),
                              pde_loss=cfg["pde_loss"], pde_metric=cfg["pde_metric"], ic_metric=cfg["ic_metric"])
        if cfg["problem"] == "linear":
            from dmip_tpu_torch.problems.linear import LinearForwardProblem

            prob = LinearForwardProblem()
            loss_fn = model.make_loss_fn(loss_cfg, initial_condition=prob.score_posterior)
            x_tr, y_tr = self.train_set
            batch_fn = lambda g: data.linear_epoch_batches(g, x_tr, y_tr, prob.noise_std, self.batch)
        else:
            from dmip_tpu_torch.problems import scatterometry as scat

            fwd, fp = scat.load_forward_model(device=dev)
            score = scat.score_posterior(fwd, fp["a"], fp["b"], fp["lambd_bd"])
            loss_fn = model.make_loss_fn(loss_cfg, initial_condition=score, forward_model=fwd, forward_params=fp)
            batch_fn = lambda g: data.scatterometry_epoch_batches(g, fwd, fp["a"], fp["b"], fp["lambd_bd"],
                                                                  self.batch, self.steps_per_epoch)
        opt = train.build_optimizer(float(cfg["lr"]))
        return train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=self.epc), opt

    def setup(self) -> None:
        cfg, dev = self.cell.config, self.cell.device
        with self.spans.span("setup.inputs"):
            self.params0 = common.mlp_weights(self.cell.generator(0), common.net_dims(cfg))
            if cfg["problem"] == "linear":
                x = torch.randn(self.n_train, cfg["xdim"], generator=self.cell.generator(2), device=dev)
                self.train_set = (x, ref_linear.forward(x))
        with self.spans.span("setup.program"):
            self.engine, opt = self._program()
            state0 = opt.init(self.params0)
        with self.spans.span("setup.warmup"):
            # the first epoch, through the window's own engine: captures the step
            p, s, losses, infos = self.engine(self.params0, state0, self.train_seed, 0, 1)
            self.first = {"loss": float(losses[0]), "info": {k: float(v[0]) for k, v in infos.items()},
                          "params": [t.clone() for wb in p for t in wb],
                          "mu": [t.clone() for wb in s.mu for t in wb], "nu": [t.clone() for wb in s.nu for t in wb]}
        self.state = (p, s)

    def window(self, seconds: float, tracer) -> dict:
        (params, opt_state), epoch = self.state, 1
        k, pending, t0 = 0, None, time.perf_counter()
        while True:
            tracer.start(k)
            with self.spans.span("queue"):
                if k == self.check_call:
                    entry = (_clone(params), _clone(opt_state))
                params, opt_state, losses, infos = self.engine(params, opt_state, self.train_seed, epoch, self.epc)
                staged = _to_host(losses)
                if k == self.check_call:
                    rows = _to_host(torch.stack([losses, *infos.values()]))
                    count = _to_host(opt_state.count - entry[1].count)
                    self.checked = {"entry": entry, "epoch0": epoch, "names": list(infos), "rows": rows,
                                    "count": count}
            if pending is not None:
                with self.spans.span("read"):
                    self.losses.extend(_read(pending))
            pending = staged
            tracer.count(k, steps=self.epc * self.steps_per_epoch)
            tracer.stop(k)
            epoch += self.epc
            k += 1
            if time.perf_counter() - t0 - tracer.paused >= seconds and k > self.check_call:
                break
        with self.spans.span("read"):
            self.losses.extend(_read(pending))
        if self.cell.device.type == "cuda":
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        steps = k * self.epc * self.steps_per_epoch
        failed = sum(self.steps_per_epoch for v in self.losses if not math.isfinite(v))
        self.state = None
        return {"train_steps_per_s": steps / (t_end - t0), "attempted": steps, "failed": failed, "t_end": t_end}

    def flops_per_unit(self) -> dict:
        cfg = self.cell.config
        return {"steps": flops.pinn_step(cfg["xdim"], cfg["ydim"], cfg["hidden_layers"], self.batch)}

    def free(self) -> None:
        del self.engine
        if self.cell.device.type == "cuda":
            torch.cuda.empty_cache()

    def outputs(self) -> dict:
        c = self.checked
        rows = _read(c["rows"])
        n = self.check_epochs
        return {"start": self.first,
                "window": {"loss": rows[0][:n], "info": {name: r[:n] for name, r in zip(c["names"], rows[1:])},
                           "count": int(_read(c["count"]))}}

    def _batches(self, gen: torch.Generator):
        """An epoch's (xb, yb) as the program draws them from its generator."""
        if self.cell.config["problem"] == "linear":
            x_tr, y_tr = self.train_set
            perm = torch.randperm(x_tr.shape[0], generator=gen, device=gen.device)
            noise = torch.randn(y_tr.shape, generator=gen, device=gen.device)
            nb = self.steps_per_epoch
            xb = x_tr[perm][: nb * self.batch].reshape(nb, self.batch, -1)
            yb = (y_tr[perm] + ref_linear.NOISE_STD * noise)[: nb * self.batch].reshape(nb, self.batch, -1)
            return xb, yb
        x = ref_scat.sample_prior(self.steps_per_epoch * self.batch, gen)
        y = ref_scat.noisy_forward(self.surrogate, x, gen)
        return x.reshape(self.steps_per_epoch, self.batch, -1), y.reshape(self.steps_per_epoch, self.batch, -1)

    def _epochs(self, params, state, epoch0: int, n: int, precision, batch_keep):
        """n epochs from epoch0 by the reference: (params, state, [loss], [info])."""
        cfg, dev = self.cell.config, self.cell.device
        if cfg["problem"] == "linear":
            ic_fn = ref_linear.score_true
        else:
            ic_fn = lambda xx, yy: ref_scat.score_true(self.surrogate, xx, yy)
        loss_kw = dict(ic_fn=ic_fn, lam=float(cfg["lam"]), lam2=float(cfg["lam2"]), pde_metric=cfg["pde_metric"],
                       ic_metric=cfg["ic_metric"])
        losses, infos = [], []
        for e in range(epoch0, epoch0 + n):
            gen = ref_train.epoch_generator(self.train_seed, e, dev)
            batches = self._batches(gen)
            with precision.matmuls():
                params, state, loss, info = ref_train.run_epoch(
                    params, state, batches, lambda i: ref_train.batch_draws(gen, self.batch, cfg["xdim"]), loss_kw,
                    float(cfg["lr"]), batch_keep)
            losses.append(loss), infos.append(info)
        return params, state, losses, infos

    def reference(self, precision=REFERENCE, batch_keep=None) -> dict:
        """The start (the first epoch from the seed's net) and the judged
        call's first epochs (from the state handed to it) by the reference,
        from the same data and draws; ``batch_keep`` rows a batch plants the
        half-batch fault."""
        if self.cell.config["problem"] != "linear":
            self.surrogate = ref_scat.surrogate(common.ROOT, self.cell.device)
        params = tuple((w.clone(), b.clone()) for w, b in self.params0)
        p, s, loss, info = self._epochs(params, ref_train.adam_init(params), 0, 1, precision, batch_keep)
        start = {"loss": loss[0], "info": info[0], "params": [t for wb in p for t in wb], "mu": s["mu"],
                 "nu": s["nu"]}
        (wp, ws), c = self.checked["entry"], self.checked
        state = {"count": int(ws.count), "mu": [t for wb in ws.mu for t in wb], "nu": [t for wb in ws.nu for t in wb]}
        _, _, losses, infos = self._epochs(wp, state, c["epoch0"], self.check_epochs, precision, batch_keep)
        window = {"loss": losses, "info": {k: [d[k] for d in infos] for k in infos[0]},
                  "count": self.epc * self.steps_per_epoch}
        return {"start": start, "window": window}

    def details(self, prog: dict, ref: dict) -> dict:
        """The start's gaps leaf by leaf (W1, b1, W2, ...), as ``compare``
        takes the worst: the first moment's and the change's."""
        a, b, p0 = prog["start"], ref["start"], [t for wb in self.params0 for t in wb]
        return {"moment_by_leaf": common.leaf_gaps(a["mu"], b["mu"]),
                "change_by_leaf": common.leaf_gaps([x - y for x, y in zip(a["params"], p0)],
                                                   [x - y for x, y in zip(b["params"], p0)])}

    def compare(self, prog: dict, ref: dict) -> list:
        """The start: ``loss_gap`` (the first epoch's mean loss and terms),
        ``moment_gap`` (Adam's first moment), ``change_gap`` (the
        parameters' change), each leaf's norm against the reference's; the
        judged call: ``window_loss_gap`` (its first epochs' mean loss and
        terms) and ``count_gap`` (steps its optimizer state counted against
        the call's steps, exact)."""
        lim = self.cell.limits
        a, b, p0 = prog["start"], ref["start"], [t for wb in self.params0 for t in wb]
        loss_gap = max([common.rel_gap(a["loss"], b["loss"])]
                       + [common.rel_gap(a["info"].get(k, math.nan), v) for k, v in b["info"].items()])
        # leaves whose gradient is nought to rounding in the reference move by round-off alone
        mu_norms = [float(torch.linalg.norm(m.double())) for m in b["mu"]]
        med = sorted(mu_norms)[len(mu_norms) // 2]
        keep = [v >= 1e-3 * med for v in mu_norms]
        moment_gap = common.leaf_norm_gaps(a["mu"], b["mu"], keep)
        change_gap = common.leaf_norm_gaps([x - y for x, y in zip(a["params"], p0)],
                                           [x - y for x, y in zip(b["params"], p0)], keep)
        wa, wb = prog["window"], ref["window"]
        window_gap = max([common.rel_gap(x, y) for x, y in zip(wa["loss"], wb["loss"])]
                         + [common.rel_gap(x, y) for k, v in wb["info"].items()
                            for x, y in zip(wa["info"].get(k, [math.nan] * len(v)), v)])
        if len(wa["loss"]) != len(wb["loss"]):
            window_gap = math.inf
        return [Check("loss_gap", loss_gap, lim["loss_gap"]), Check("moment_gap", moment_gap, lim["moment_gap"]),
                Check("change_gap", change_gap, lim["change_gap"]),
                Check("window_loss_gap", window_gap, lim["window_loss_gap"]),
                Check("count_gap", float(abs(wa["count"] - wb["count"])), lim["count_gap"])]


def _clone(tree):
    """A copy of a tree of tensors (tuples, named tuples, None), queued on the
    stream behind the work that makes it."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if tree is None:
        return None
    if hasattr(tree, "_fields"):
        return type(tree)(*(_clone(t) for t in tree))
    return type(tree)(_clone(t) for t in tree)


def _to_host(t: torch.Tensor):
    """t copied to the host behind the work that makes it, and the event
    that says when it has landed."""
    if t.device.type != "cuda":
        return t.clone(), None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def _read(staged) -> list:
    host, done = staged
    if done is not None:
        done.synchronize()
    return host.tolist()
