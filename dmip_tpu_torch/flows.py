"""Conditional normalizing flows: GLOW coupling blocks, INN and SNF.

Port of ``dmip_tpu/flows.py`` with its names and its params layout, so the
JAX package's checkpoints load unchanged (``checkpoints.load_archived_params``):
an INN's params are a list of couplings ``{'s1': mlp, 's2': mlp}``; an
SNF's a list with one entry per layer, a list of couplings for a
deterministic layer and ``()`` for a stochastic one.  The coupling:

  split x -> (x1, x2) with len1 = d // 2;
  r2 = subnet2([x2, c]);  s2, t2 = split(r2);  y1 = e(s2) * x1 + t2
  r1 = subnet1([y1, c]);  s1, t1 = split(r1);  y2 = e(s1) * x2 + t1
  log_e(s) = clamp * 0.636 * atan(s)   (FrEIA 0.2's soft clamp)
  log|det J| = sum(log_e(s1)) + sum(log_e(s2))

The SNF's stochastic layers anneal to the interpolated energy
lambd * (-log p(x|y)) + (1 - lambd) |x|^2 / 2 with the chains of
:mod:`dmip_tpu_torch.mcmc`.  Training is maximum likelihood on the inverse
pass, mean(0.5 |z|^2 - logdet).

Draws come from an explicit ``torch.Generator`` (on its device, else on
the input's).  Every stochastic entry point also takes its draws: ``z=``
for ``sample`` and, through ``draws=`` (one entry per layer, None for a
deterministic one), a stochastic layer's ``noise`` / ``uniforms`` (MCMC and
MALA layers, in :func:`~dmip_tpu_torch.mcmc.anneal_to_energy`'s layout) or
``eta`` (Langevin layers), so two implementations can be fed the same
random numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from . import mcmc as M
from .nets import mlp_apply, mlp_init

Tensor = torch.Tensor
EnergyFn = Callable[[Tensor, Tensor], Tensor]

_CLAMP_GAIN = 0.636  # FrEIA's 2/pi approximation


def _log_e(s: Tensor, clamp: float) -> Tensor:
    """FrEIA 0.2's soft clamp, clamp * 0.636 * atan(s), in (-clamp, clamp);
    the argument is not divided by clamp (the pre-0.2 form)."""
    return clamp * _CLAMP_GAIN * torch.atan(s)


def subnet_init(c_in: int, c_out: int, width: int, generator: Optional[torch.Generator] = None, device=None):
    """Linear-ReLU-Linear-ReLU-Linear subnet, torch.nn.Linear's init."""
    return mlp_init(c_in, c_out, (width, width), generator=generator, device=device)


def _subnet_apply(params, h: Tensor) -> Tensor:
    return mlp_apply(params, h, activation=torch.relu)


# ---------------------------------------------------------------------------
# GLOW coupling block
# ---------------------------------------------------------------------------


def coupling_init(d: int, cond_dim: int, width: int, generator: Optional[torch.Generator] = None, device=None):
    """Params of one conditional GLOW coupling block on R^d."""
    len1, len2 = d // 2, d - d // 2
    return {
        "s1": subnet_init(len1 + cond_dim, 2 * len2, width, generator, device),
        "s2": subnet_init(len2 + cond_dim, 2 * len1, width, generator, device),
    }


def _cat(h: Tensor, c: Optional[Tensor]) -> Tensor:
    return h if c is None else torch.cat([h, c], dim=1)


def coupling_forward(params, x: Tensor, c: Optional[Tensor], d: int, clamp: float = 1.4) -> Tuple[Tensor, Tensor]:
    len1 = d // 2
    x1, x2 = x[:, :len1], x[:, len1:]
    r2 = _subnet_apply(params["s2"], _cat(x2, c))
    s2, t2 = r2[:, :len1], r2[:, len1:]
    y1 = torch.exp(_log_e(s2, clamp)) * x1 + t2
    r1 = _subnet_apply(params["s1"], _cat(y1, c))
    s1, t1 = r1[:, :x2.shape[1]], r1[:, x2.shape[1]:]
    y2 = torch.exp(_log_e(s1, clamp)) * x2 + t1
    logdet = torch.sum(_log_e(s1, clamp), dim=1) + torch.sum(_log_e(s2, clamp), dim=1)
    return torch.cat([y1, y2], dim=1), logdet


def coupling_inverse(params, y: Tensor, c: Optional[Tensor], d: int, clamp: float = 1.4) -> Tuple[Tensor, Tensor]:
    len1 = d // 2
    y1, y2 = y[:, :len1], y[:, len1:]
    r1 = _subnet_apply(params["s1"], _cat(y1, c))
    s1, t1 = r1[:, :y2.shape[1]], r1[:, y2.shape[1]:]
    x2 = (y2 - t1) * torch.exp(-_log_e(s1, clamp))
    r2 = _subnet_apply(params["s2"], _cat(x2, c))
    s2, t2 = r2[:, :len1], r2[:, len1:]
    x1 = (y1 - t2) * torch.exp(-_log_e(s2, clamp))
    logdet = -(torch.sum(_log_e(s1, clamp), dim=1) + torch.sum(_log_e(s2, clamp), dim=1))
    return torch.cat([x1, x2], dim=1), logdet


def _couplings_init(n: int, d: int, cond_dim: int, width: int, generator, device) -> List[dict]:
    return [coupling_init(d, cond_dim, width, generator, device) for _ in range(n)]


def _couplings(params, x: Tensor, c: Tensor, d: int, clamp: float, inverse: bool) -> Tuple[Tensor, Tensor]:
    logdet = torch.zeros(x.shape[0], dtype=x.dtype, device=x.device)
    for p in (reversed(params) if inverse else params):
        x, ld = (coupling_inverse if inverse else coupling_forward)(p, x, c, d, clamp)
        logdet = logdet + ld
    return x, logdet


# ---------------------------------------------------------------------------
# Conditional INN (a stack of coupling blocks)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class INN:
    num_layers: int
    sub_net_size: int
    dimension: int
    dimension_condition: int
    clamp: float = 1.4

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        return _couplings_init(self.num_layers, self.dimension, self.dimension_condition, self.sub_net_size,
                               generator, device)

    def forward(self, params, x: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
        return _couplings(params, x, c, self.dimension, self.clamp, inverse=False)

    def inverse(self, params, z: Tensor, c: Tensor) -> Tuple[Tensor, Tensor]:
        return _couplings(params, z, c, self.dimension, self.clamp, inverse=True)

    def sample(self, params, y: Tensor, n: int, generator: Optional[torch.Generator] = None,
               z: Optional[Tensor] = None) -> Tensor:
        """n posterior samples given y: the forward pass of z ~ N(0, I),
        or of the given ``z`` (n, dimension)."""
        z = M._draw(torch.randn, (n, self.dimension), generator, y, z)
        return self.forward(params, z, y.expand(n, self.dimension_condition))[0]


def create_inn(num_layers, sub_net_size, dimension=5, dimension_condition=5) -> INN:
    return INN(num_layers, sub_net_size, dimension, dimension_condition)


def inn_ml_loss(inn: INN, params, x: Tensor, y: Tensor) -> Tensor:
    """Maximum-likelihood loss mean(0.5 |z|^2 - logdet) on the inverse pass."""
    z, jac_inv = inn.inverse(params, x, y)
    return torch.mean(0.5 * torch.sum(z**2, dim=1) - jac_inv)


# ---------------------------------------------------------------------------
# Stochastic normalizing flow
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class DeterministicLayer:
    """``num_inn_layers`` coupling blocks."""

    num_inn_layers: int
    sub_net_size: int
    dimension: int
    dimension_condition: int
    clamp: float = 1.4

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        return _couplings_init(self.num_inn_layers, self.dimension, self.dimension_condition, self.sub_net_size,
                               generator, device)

    def forward(self, params, x: Tensor, ys: Tensor) -> Tuple[Tensor, Tensor]:
        return _couplings(params, x, ys, self.dimension, self.clamp, inverse=False)

    def backward(self, params, x: Tensor, ys: Tensor) -> Tuple[Tensor, Tensor]:
        return _couplings(params, x, ys, self.dimension, self.clamp, inverse=True)


@dataclasses.dataclass(frozen=True)
class MCMCLayer:
    """Random-walk Metropolis steps annealing to the interpolated energy;
    the log-det is the carried energy's change.  Draws: ``noise``
    (steps, n, d), ``uniforms`` (steps, n)."""

    lambd: float
    noise_std: float
    metr_steps_per_block: int

    def init(self, generator=None, device=None):
        return ()

    def forward(self, params, x: Tensor, ys: Tensor, energy_fn: EnergyFn, generator=None,
                noise: Optional[Tensor] = None, uniforms: Optional[Tensor] = None):
        energy = M.interpolated_energy(ys, self.lambd, energy_fn)
        return M.anneal_to_energy(x, energy, self.metr_steps_per_block, noise_std=self.noise_std,
                                  generator=generator, noise=noise, uniforms=uniforms)

    backward = forward


@dataclasses.dataclass(frozen=True)
class MALALayer:
    """Metropolis steps with Langevin proposals; the stepsize is divided
    by lambd, as the reference does.  Draws: ``noise`` (steps, lang_steps,
    n, d), ``uniforms`` (steps, n)."""

    lambd: float
    metr_steps_per_block: int
    lang_steps: int
    stepsize: float

    def init(self, generator=None, device=None):
        return ()

    def forward(self, params, x: Tensor, ys: Tensor, energy_fn: EnergyFn, generator=None,
                noise: Optional[Tensor] = None, uniforms: Optional[Tensor] = None):
        energy = M.interpolated_energy(ys, self.lambd, energy_fn)
        return M.anneal_to_energy(x, energy, self.metr_steps_per_block, generator=generator, langevin_prop=True,
                                  noise=noise, uniforms=uniforms, lang_steps=self.lang_steps,
                                  stepsize=self.stepsize / self.lambd)

    backward = forward


@dataclasses.dataclass(frozen=True)
class LangevinLayer:
    """Unadjusted Langevin steps with their log-det correction.  Draws:
    ``eta`` (lang_steps, n, d)."""

    lambd: float
    lang_steps: int
    stepsize: float

    def init(self, generator=None, device=None):
        return ()

    def forward(self, params, x: Tensor, ys: Tensor, energy_fn: EnergyFn, generator=None,
                eta: Optional[Tensor] = None):
        energy = M.interpolated_energy(ys, self.lambd, energy_fn)
        z, log_det, _, _ = M.langevin_step(x, self.stepsize, energy, self.lang_steps, generator=generator, eta=eta)
        return z, log_det

    backward = forward


Draws = Optional[Sequence[Optional[dict]]]


@dataclasses.dataclass(frozen=True)
class SNF:
    """Alternating deterministic and stochastic layers.  ``energy_fn(x,
    ys) -> (n,)`` is the problem's negative log posterior."""

    layers: Tuple[Any, ...]
    energy_fn: Optional[EnergyFn] = None

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        return [layer.init(generator, device) for layer in self.layers]

    def _layer(self, i: int, params, zs: Tensor, ys: Tensor, backward: bool, generator, draws: Draws):
        layer = self.layers[i]
        if isinstance(layer, DeterministicLayer):
            return (layer.backward if backward else layer.forward)(params[i], zs, ys)
        given = (draws[i] if draws is not None else None) or {}
        return layer.forward(params[i], zs, ys, self.energy_fn, generator=generator, **given)

    def _apply(self, params, zs: Tensor, ys: Tensor, backward: bool, generator, draws: Draws):
        logdet = torch.zeros(zs.shape[0], dtype=zs.dtype, device=zs.device)
        order = range(len(self.layers))
        for i in (reversed(order) if backward else order):
            zs, ld = self._layer(i, params, zs, ys, backward, generator, draws)
            logdet = logdet + ld
        return zs, logdet

    def forward(self, params, zs: Tensor, ys: Tensor, generator: Optional[torch.Generator] = None,
                draws: Draws = None) -> Tuple[Tensor, Tensor]:
        return self._apply(params, zs, ys, False, generator, draws)

    def forward_all(self, params, zs: Tensor, ys: Tensor, generator: Optional[torch.Generator] = None,
                    draws: Draws = None) -> List[Tensor]:
        """The forward pass's samples before the first layer and after each."""
        outs = [zs]
        for i in range(len(self.layers)):
            zs, _ = self._layer(i, params, zs, ys, False, generator, draws)
            outs.append(zs)
        return outs

    def backward(self, params, zs: Tensor, ys: Tensor, generator: Optional[torch.Generator] = None,
                 draws: Draws = None) -> Tuple[Tensor, Tensor]:
        return self._apply(params, zs, ys, True, generator, draws)

    def sample(self, params, y: Tensor, n: int, generator: Optional[torch.Generator] = None,
               z: Optional[Tensor] = None, draws: Draws = None) -> Tensor:
        """n posterior samples given y: z ~ N(0, I) (or the given ``z``),
        then the layers' draws, through the forward pass."""
        d, cdim = self.layers[0].dimension, self.layers[0].dimension_condition
        z = M._draw(torch.randn, (n, d), generator, y, z)
        return self.forward(params, z, y.expand(n, cdim), generator, draws)[0]


def _stochastic(lambd, metr_steps_per_block, noise_std, lang_steps, lang_steps_prop, step_size, langevin_prop):
    layers: List[Any] = []
    if metr_steps_per_block > 0:
        if lang_steps > 0:
            layers.append(LangevinLayer(lambd, lang_steps, step_size))
        if langevin_prop:
            layers.append(MALALayer(lambd, metr_steps_per_block, lang_steps_prop, step_size))
        else:
            layers.append(MCMCLayer(lambd, noise_std, metr_steps_per_block))
    return layers


def create_snf(
    num_layers: int,
    sub_net_size: int,
    energy_fn: EnergyFn,
    metr_steps_per_block: int = 3,
    dimension_condition: int = 5,
    dimension: int = 5,
    noise_std: float = 0.4,
    num_inn_layers: int = 1,
    lang_steps: int = 0,
    lang_steps_prop: int = 1,
    step_size: float = 5e-3,
    langevin_prop: bool = False,
) -> SNF:
    """``num_layers`` x (a deterministic layer, then its stochastic layers
    at lambd = (k + 1) / num_layers)."""
    layers: List[Any] = []
    for k in range(num_layers):
        layers.append(DeterministicLayer(num_inn_layers, sub_net_size, dimension, dimension_condition))
        layers += _stochastic((k + 1) / num_layers, metr_steps_per_block, noise_std, lang_steps, lang_steps_prop,
                              step_size, langevin_prop)
    return SNF(tuple(layers), energy_fn)


def create_snf_last_layer(
    num_layers: int,
    sub_net_size: int,
    energy_fn: EnergyFn,
    metr_steps_per_block: int = 3,
    dimension_condition: int = 5,
    dimension: int = 5,
    noise_std: float = 0.4,
    num_inn_layers: int = 1,
    lang_steps: int = 0,
    lang_steps_prop: int = 1,
    step_size: float = 5e-3,
    langevin_prop: bool = False,
) -> SNF:
    """The stochastic layers only after the last deterministic one, at
    lambd = 1."""
    layers: List[Any] = [DeterministicLayer(num_inn_layers, sub_net_size, dimension, dimension_condition)
                         for _ in range(num_layers)]
    layers += _stochastic(1.0, metr_steps_per_block, noise_std, lang_steps, lang_steps_prop, step_size,
                          langevin_prop)
    return SNF(tuple(layers), energy_fn)


def snf_ml_loss(snf: SNF, params, x: Tensor, y: Tensor, generator: Optional[torch.Generator] = None,
                draws: Draws = None) -> Tensor:
    """mean(0.5 |z|^2 - logdet) on the backward pass."""
    z, jac_inv = snf.backward(params, x, y, generator, draws)
    return torch.mean(0.5 * torch.sum(z**2, dim=1) - jac_inv)


def snf_draws(snf: SNF, generator: Optional[torch.Generator], x: Tensor) -> List[Optional[dict]]:
    """What :func:`snf_ml_loss` draws from ``generator`` for the batch x
    (n, d), in the layout of its ``draws=``: the backward pass runs the
    layers last first, and each Metropolis step draws its proposal's
    normals, then its n uniforms; a Langevin layer its ``lang_steps``
    normals.  Handed back, they give the loss it computes from the
    generator, bit for bit."""
    n, d = x.shape
    dev = generator.device if generator is not None else x.device

    def draw(sample, shape):
        return sample(shape, generator=generator, device=dev, dtype=x.dtype).to(x.device)

    def normals(k: int) -> Tensor:
        return torch.stack([draw(torch.randn, (n, d)) for _ in range(k)]) if k else x.new_empty((0, n, d))

    out: List[Optional[dict]] = [None] * len(snf.layers)
    for i in reversed(range(len(snf.layers))):
        layer = snf.layers[i]
        if isinstance(layer, LangevinLayer):
            out[i] = {"eta": normals(layer.lang_steps)}
        elif isinstance(layer, (MCMCLayer, MALALayer)):
            noise, uniforms = [], []
            for _ in range(layer.metr_steps_per_block):
                noise.append(normals(layer.lang_steps) if isinstance(layer, MALALayer) else draw(torch.randn, (n, d)))
                uniforms.append(draw(torch.rand, (n,)))
            shape = (0, layer.lang_steps, n, d) if isinstance(layer, MALALayer) else (0, n, d)
            out[i] = {"noise": torch.stack(noise) if noise else x.new_empty(shape),
                      "uniforms": torch.stack(uniforms) if uniforms else x.new_empty((0, n))}
    return out


def snf_loss_fn(snf: SNF):
    """The SNF's loss for the epoch engines (``train.make_epoch_fn``):
    loss(params, generator, x, y, *, draws=None) -> (:func:`snf_ml_loss`,
    {}), and ``loss.draws(generator, x, y)`` -> {'draws': :func:`snf_draws`},
    so an engine can draw the layers' numbers before the step.
    ``loss.local_draws(mesh, draws)`` cuts them to a rank's rows of the
    batch for the data-parallel step: a draw's rows are its axis -2 (the
    last is the dimension), the uniforms' its last axis."""

    def loss_fn(params, generator, x: Tensor, y: Tensor, *, draws: Draws = None):
        return snf_ml_loss(snf, params, x, y, generator, draws), {}

    def local_draws(mesh, draws):
        rows = lambda k, v: mesh.local(v, axis=v.ndim - (1 if k == "uniforms" else 2))
        return {"draws": [None if d is None else {k: rows(k, v) for k, v in d.items()} for d in draws["draws"]]}

    loss_fn.draws = lambda generator, x, y: {"draws": snf_draws(snf, generator, x)}
    loss_fn.local_draws = local_draws
    return loss_fn


def inn_loss_fn(inn: INN):
    """The INN's loss for the epoch engines: loss(params, generator, x, y)
    -> (:func:`inn_ml_loss`, {}); it draws nothing (``loss.draws`` gives
    {})."""

    def loss_fn(params, generator, x: Tensor, y: Tensor):
        return inn_ml_loss(inn, params, x, y), {}

    loss_fn.draws = lambda generator, x, y: {}
    return loss_fn
