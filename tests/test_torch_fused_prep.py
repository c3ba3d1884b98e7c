"""The fused DSM engine's preparation of whole epochs and ``fit``'s late read.

The DSM loss draws an epoch's t and eps at once (``epoch_draws``, rows
(nb, B, .)), and the fused engine (``make_fused_dsm_epoch_fn``) prepares a
call's epochs in a fixed number of tensor calls an epoch, whatever the
number of batches: the counterpart of the JAX engine's vmapped
``prep_epoch``.  Here, on the CPU (the engine's eager preparation; its CUDA
graph replays it on the card, ``tests/test_torch_cuda.py``): the aten calls
of a preparation against the number of batches, the prepared (h0, eps, s1)
against the per-batch composition bit for bit and against the JAX package's
own composition, re-chunking on both engines, the other losses' per-batch
streams, and ``train.fit`` reading each call one call late.  Small nets
(32 wide), 16 rows a batch.
"""

import contextlib
import io
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from dmip_tpu.models.diffusion import CDE as JCDE
from dmip_tpu.models.diffusion import CDiffE as JCDiffE
from dmip_tpu_torch import data, pytree, train
from dmip_tpu_torch.models.diffusion import loss_keywords
from dmip_tpu_torch.ops.dsm_train_kernel import make_fused_dsm_epoch_fn
from dmip_tpu_torch.problems import LinearForwardProblem
from dmip_tpu_torch.sde import sample_t

BATCH, SEED = 16, 11
WIDTH = [32, 32]
JAX_MODELS = {"CDE": JCDE, "CDiffE": JCDiffE}


class AtenCalls(TorchDispatchMode):
    """Counts the aten calls made inside it."""

    def __init__(self):
        super().__init__()
        self.calls = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.calls[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def _setup(model_name="CDE", n_batches=3, loss="DSM"):
    prob = LinearForwardProblem()
    xs, ys = data.generate_dataset_linear(2, prob.forward, BATCH * n_batches, torch.Generator().manual_seed(0))
    model, cfg = train.get_model_from_args({"model": model_name, "loss_fn": loss, "hidden_layers": WIDTH,
                                            "lam": 0.1, "lam2": 0.1}, {"xdim": 2, "ydim": 2})
    batch_fn = lambda g: data.linear_epoch_batches(g, xs, ys, prob.noise_std, BATCH)
    loss_fn = model.make_loss_fn(cfg, initial_condition=prob.score_posterior)
    return model, loss_fn, batch_fn, model.init(torch.Generator().manual_seed(1))


def _equal(a, b) -> bool:
    la, lb = pytree.leaves(a), pytree.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _prep_calls(n_batches: int, epochs_per_call: int) -> Counter:
    model, _, batch_fn, _ = _setup(n_batches=n_batches)
    fn = make_fused_dsm_epoch_fn(model, 1e-3, batch_fn, epochs_per_call=epochs_per_call)
    fn.prepare(SEED, 0, "cpu")  # builds the cached constants
    with AtenCalls() as mode:
        h0 = fn.prepare(SEED, epochs_per_call, "cpu")[0]
    assert h0.shape == (epochs_per_call, n_batches, BATCH, 5)
    return mode.calls


def test_a_preparation_makes_the_same_aten_calls_for_3_and_12_batches():
    """One call's preparation makes the same aten calls, op by op, for 3
    and for 12 batches an epoch, and each epoch of a call adds the same
    calls: none of them runs once a batch."""
    calls = {nb: _prep_calls(nb, 2) for nb in (3, 12)}
    assert calls[3] == calls[12] and sum(calls[3].values()) > 0
    one, three = _prep_calls(3, 1), _prep_calls(3, 3)
    per_epoch = calls[3] - one
    assert per_epoch == three - calls[3] and sum(per_epoch.values()) < 40
    assert per_epoch["aten.rand"] == 1 and per_epoch["aten.randn"] == 2  # t's uniforms, eps, y's noise


@pytest.mark.parametrize("name", ["CDE", "CDiffE"])
def test_prepared_inputs_are_the_per_batch_composition(name):
    """On the same epoch draws, the prepared (h0, eps, s1) are, batch by
    batch, diffusion_state, diffuse, the net's input columns and std / g
    bit for bit; for the t and eps they fed, the JAX package's own
    composition (plain jnp: diffusion_state, sde.base.diffuse, std / g)
    within 1e-6.  For the CDiffE this holds diffusion_state to the last
    axis on (E, nb, B, .) batches."""
    model, _, batch_fn, _ = _setup(name, n_batches=4)
    base = model.sde.base
    fn = make_fused_dsm_epoch_fn(model, 1e-3, batch_fn, epochs_per_call=2)
    h0, ep, s1 = fn.prepare(SEED, 5, "cpu")
    jmodel = JAX_MODELS[name](xdim=2, ydim=2, hidden_layers=tuple(WIDTH))
    jbase = jmodel.sde.base
    for j in range(2):
        gen = train.epoch_generator(SEED, 5 + j, "cpu")
        xb, yb = batch_fn(gen)
        t, eps = model.epoch_draws(gen, xb, yb)
        assert t.shape == (4, BATCH, 1) and eps.shape == (4, BATCH, model.net_out)
        for i in range(4):
            z0, cond = model.diffusion_state(xb[i], yb[i])
            z_t = base.diffuse(t[i], z0, eps[i])
            want = torch.cat([z_t, cond, t[i]] if name == "CDE" else [z_t, t[i]], dim=1)
            assert torch.equal(h0[j, i], want) and torch.equal(ep[j, i], eps[i])
            assert torch.equal(s1[j, i], (base.std(t[i]) / base.g(t[i])).expand(eps[i].shape))
            jt, jeps = jnp.asarray(t[i].numpy()), jnp.asarray(eps[i].numpy())
            jz0, jcond = jmodel.diffusion_state(jnp.asarray(xb[i].numpy()), jnp.asarray(yb[i].numpy()))
            jz_t = jbase.diffuse(jt, jz0, jeps)
            jh0 = jnp.concatenate([jz_t, jcond, jt] if name == "CDE" else [jz_t, jt], axis=1)
            np.testing.assert_allclose(h0[j, i].numpy(), np.asarray(jh0), rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(s1[j, i].numpy(), np.broadcast_to(np.asarray(jbase.std(jt) / jbase.g(jt)),
                                                                         jeps.shape), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["CDE", "CDiffE"])
def test_dsm_epoch_draws_are_two_whole_epoch_calls(name):
    """epoch_draws is one torch.rand((nb, B, 1)) through sample_t, then one
    torch.randn of z0's shape, from the generator; the loss handed batch
    i's row computes the fused kernel's objective 1/2 sum (a s1 + eps)^2 / B
    on that batch's diffused state (1e-6), and another row another value."""
    model, loss_fn, batch_fn, params = _setup(name, n_batches=3)
    base = model.sde.base
    xb, yb = batch_fn(torch.Generator().manual_seed(2))
    drawn = loss_fn.epoch_draws(torch.Generator().manual_seed(9), xb, yb)
    gen = torch.Generator().manual_seed(9)
    u = torch.rand((3, BATCH, 1), generator=gen)
    eps = torch.randn((3, BATCH, model.net_out), generator=gen)
    assert torch.equal(drawn["t"], sample_t(model.sde, BATCH, u=u)) and torch.equal(drawn["eps"], eps)
    values = []
    for i in range(3):
        t, e = drawn["t"][i], drawn["eps"][i]
        values.append(loss_fn(params, None, xb[i], yb[i], **loss_keywords(t, e))[0].item())
        z0, cond = model.diffusion_state(xb[i], yb[i])
        out = model.apply_a(params, base.diffuse(t, z0, e), cond if name == "CDE" else None, t)
        objective = 0.5 * float(((out * (base.std(t) / base.g(t)) + e) ** 2).sum()) / BATCH
        assert values[-1] == pytest.approx(objective, rel=1e-6)
    assert len(set(values)) == 3


@pytest.mark.parametrize("loss", ["PINNLoss", "DSM_PDE", "PINNLoss2"])
def test_only_dsm_draws_by_epoch(loss):
    """The other diffusion losses keep their per-batch draws only."""
    _, loss_fn, _, _ = _setup(loss=loss)
    assert hasattr(loss_fn, "draws") and not hasattr(loss_fn, "epoch_draws")


def _engine(kind, epochs_per_call):
    model, loss_fn, batch_fn, params = _setup(n_batches=3)
    opt = train.build_optimizer(1e-3)
    if kind == "fused":
        return make_fused_dsm_epoch_fn(model, 1e-3, batch_fn, epochs_per_call, compute_dtype=torch.float32), \
            opt, params
    return train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=epochs_per_call), opt, params


@pytest.mark.parametrize("kind", ["fused", "autograd"])
def test_two_calls_of_one_epoch_are_one_call_of_two(kind):
    """Each epoch draws from its own generator, so two calls of one epoch
    give one call of two epochs' params, Adam state and losses bit for bit."""
    fn1, opt, params = _engine(kind, 1)
    fn2, _, _ = _engine(kind, 2)
    p, s, l0, _ = fn1(params, opt.init(params), SEED, 4)
    p, s, l1, _ = fn1(p, s, SEED, 5)
    q, r, l2, _ = fn2(params, opt.init(params), SEED, 4)
    assert _equal(p, q) and _equal(s, r) and torch.equal(torch.cat([l0, l1]), l2)
    assert int(s.count) == 6 and bool(torch.isfinite(l2).all())


def test_pinn_engine_is_the_per_batch_loop():
    """PINNLoss through make_epoch_fn equals a loop that draws each batch's
    numbers by loss_fn.draws just before its step, bit for bit."""
    model, loss_fn, batch_fn, params = _setup(loss="PINNLoss", n_batches=3)
    opt = train.build_optimizer(1e-3, grad_clip=1.0)
    step = train.make_train_step(loss_fn, opt)
    p, s, losses = params, opt.init(params), []
    for e in range(2):
        gen = train.epoch_generator(SEED, e, "cpu")
        xb, yb = batch_fn(gen)
        ls = []
        for x, y in zip(xb, yb):
            p, s, loss, _ = step(p, s, None, x, y, loss_fn.draws(gen, x, y))
            ls.append(loss)
        losses.append(torch.stack(ls).mean())
    q, r, got, _ = train.make_epoch_fn(loss_fn, opt, batch_fn, epochs_per_call=2)(params, opt.init(params), SEED, 0)
    assert _equal(p, q) and _equal(s, r) and torch.equal(got, torch.stack(losses))


class _Log:
    def __init__(self, events):
        self.events = events

    def scalar(self, tag, value, step):
        self.events.append(("log", tag, value, step))


def _stub_engine(events, epochs_per_call):
    """An epoch_fn whose losses and info follow from (seed, epoch0), and
    that notes each call."""

    def epochs(params, opt_state, seed, epoch0, n_active):
        events.append(("call", epoch0))
        ep = torch.arange(epoch0, epoch0 + epochs_per_call, dtype=torch.float32)
        losses = torch.where(ep < epoch0 + n_active, 1.0 / (ep + seed), torch.nan)
        return params + 1, opt_state + 2, losses, {"A": losses * 2, "B": -losses}

    return epochs


def _fit_at_once(epoch_fn, params, seed, num_epochs, epochs_per_call, log_every, logger, desc, opt_state,
                 start_epoch, clock):
    """``fit`` reading each call as soon as it returns."""
    last_info = {}
    t0 = clock()
    n_calls = -(-max(num_epochs - start_epoch, 0) // epochs_per_call)
    epoch = start_epoch
    for c in range(n_calls):
        n_active = min(epochs_per_call, num_epochs - epoch)
        params, opt_state, losses, infos = epoch_fn(params, opt_state, seed, epoch, n_active)
        losses = losses.tolist()
        infos = {k: v.tolist() for k, v in infos.items()}
        for j in range(n_active):
            logger.scalar("Train/Loss", float(losses[j]), epoch)
            for k, v in infos.items():
                logger.scalar("Train/" + k, float(v[j]), epoch)
            epoch += 1
        if log_every and (c % max(log_every // epochs_per_call, 1) == 0 or c == n_calls - 1):
            rate = (epoch - start_epoch) / (clock() - t0)
            print(f"[{desc}] epoch {epoch}/{num_epochs} loss={float(losses[n_active - 1]):.4f} "
                  f"({rate:.1f} epochs/s)", flush=True)
        last_info = {k: float(v[n_active - 1]) for k, v in infos.items()}
    return params, opt_state, last_info


@pytest.mark.parametrize("num_epochs,epochs_per_call,log_every,start", [(11, 3, 6, 0), (4, 4, 1, 0), (9, 2, 0, 3)])
def test_fit_reads_one_call_late_as_it_read_at_once(monkeypatch, num_epochs, epochs_per_call, log_every, start):
    """fit queues call k + 1 before it reads call k: the same logged
    (epoch, value) list, printed lines and last info as the order that
    reads each call at once, on the same clock; the reads come one call
    late and the last call is read before fit returns."""
    ticks = iter(range(1, 1000))
    clock = lambda: float(next(ticks))
    runs = {}
    for name in ("late", "at_once"):
        ticks = iter(range(1, 1000))
        events = []
        fn = _stub_engine(events, epochs_per_call)
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if name == "late":
                monkeypatch.setattr(train.time, "time", clock)
                res = train.fit(fn, 0, None, SEED, num_epochs, epochs_per_call=epochs_per_call, log_every=log_every,
                                logger=_Log(events), desc="stub", opt_state=0, start_epoch=start)
                monkeypatch.undo()
            else:
                res = _fit_at_once(fn, 0, SEED, num_epochs, epochs_per_call, log_every, _Log(events), "stub", 0,
                                   start, clock)
        runs[name] = (events, out.getvalue(), res)
    (late, printed, res), (at_once, printed_at_once, res_at_once) = runs["late"], runs["at_once"]
    logs = lambda ev: [e for e in ev if e[0] == "log"]
    assert logs(late) == logs(at_once) and printed == printed_at_once and res == res_at_once
    assert len(logs(late)) == 3 * (num_epochs - start) and res[2] and (printed != "") == bool(log_every)
    calls = [i for i, e in enumerate(late) if e[0] == "call"]
    first_log = [next(i for i, e in enumerate(late) if e[0] == "log" and e[3] == e0) for _, e0 in
                 (late[i] for i in calls)]
    assert all(calls[k + 1] < first_log[k] for k in range(len(calls) - 1))
    assert late[-1][0] == "log"
