"""Score-based diffusion models for inverse problems: CDE, CDiffE and DPS.

Port of ``dmip_tpu/models/diffusion.py``: ``LossConfig``,
``DiffusionModel`` and ``CDE`` with ``init``, ``apply_a``,
``diffusion_state``, ``make_loss_fn`` (DSM, DSM_PDE, PINNLoss, PINNLoss2)
and ``sample``; ``CDiffE`` (the joint diffusion of [x, y]);
``PosteriorDiffusionEstimator`` (prior + likelihood nets, trained with the
PosteriorLoss);
``AnalyticGuidanceDPS`` (a prior net guided by the exact likelihood
gradient through the frozen surrogate).  Parameters live outside the model:
a tuple of (W, b) tensors, or for the posterior models a dict of them.

``sample(method="auto")`` launches the model's fused kernel for a CUDA
device (B1 for the CDE, B4 for the CDiffE, B5 for analytic guidance with
surrogate weights) and runs the plain Euler-Maruyama scan for the CPU.  The
CDE and the Posterior model also sample by ``heun`` and
``expint[:ode|:sde][:1|:2]``, plain PyTorch on either device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from .. import losses as L
from .. import nets, samplers
from ..sde import ReverseSDE, sample_t

Tensor = torch.Tensor


def _device_of(params, y: Optional[Tensor], device) -> torch.device:
    if device is not None:
        return torch.device(device)
    if y is not None:
        return y.device
    first = params["prior"] if isinstance(params, dict) else params
    return first[0][0].device


def _resolve_method(method: str, dev: torch.device, kernel_ok: bool = True) -> str:
    """'kernel' or 'plain' for 'auto' (the kernel on a CUDA device), else
    the method itself: 'kernel', 'plain', 'heun' or 'expint...'."""
    if method == "heun" or method == "expint" or method.startswith("expint:"):
        return method
    if method == "auto":
        return "kernel" if dev.type == "cuda" and kernel_ok else "plain"
    if method not in ("kernel", "plain"):
        raise ValueError(f"unknown sampler method {method!r}")
    return method


def _expint_options(method: str) -> Tuple[bool, int]:
    """(ode, order) of 'expint[:ode|:sde][:1|:2]'; the default is the SDE
    form of order 1."""
    ode, order = False, 1
    for part in method.split(":")[1:]:
        if part in ("ode", "sde"):
            ode = part == "ode"
        elif part in ("1", "2"):
            order = int(part)
        else:
            raise ValueError(f"bad expint option {part!r} in method {method!r}; grammar is expint[:ode|:sde][:1|:2]")
    return ode, order


def loss_keywords(t: Tensor, eps: Tensor, v: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """The draws (t, eps, v) of :meth:`DiffusionModel.loss_draws` as the
    loss's keywords; v only when the loss draws a probe."""
    return {"t": t, "eps": eps} if v is None else {"t": t, "eps": eps, "v": v}


def _kernel_draws(generator, num_samples: int, xdim: int, mean: float, std: float, dev):
    """x0 ~ N(mean, std^2) and the seed of a kernel's Philox stream, both
    from ``generator`` (on its device), x0 moved to ``dev``.  The seed is an
    int from a CPU generator, and from a CUDA one a one-element int64
    tensor on ``dev``, which the kernel reads there: the card does not stop
    to hand it to the host."""
    gen_dev = torch.device(generator.device if generator is not None else "cpu")
    x0 = torch.randn(num_samples, xdim, generator=generator, device=gen_dev)
    seed = torch.randint(0, 2**62, (1,), generator=generator, device=gen_dev)
    seed = int(seed) if gen_dev.type == "cpu" else seed.to(dev)
    return (x0 * std + mean).to(dev), seed


def _draws_probe(cfg) -> bool:
    """Whether a PDE loss of ``cfg`` draws a Hutchinson probe."""
    return cfg.divergence_method != "exact" and cfg.pde_loss != "cScoreFPE"


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Training objective selection (mirrors dmip_tpu's LossConfig)."""

    name: str = "DSM"
    lam: float = 1.0
    lam2: float = 1.0
    pde_loss: str = "FPE"
    pde_metric: str = "L1"
    ic_metric: str = "L1"
    divergence_method: str = "exact"


@dataclasses.dataclass(frozen=True)
class DiffusionModel:
    xdim: int
    ydim: int
    hidden_layers: Tuple[int, ...] = (512, 512, 512)
    sde: ReverseSDE = dataclasses.field(default_factory=ReverseSDE)

    @property
    def net_in(self) -> int:
        return self.xdim + self.ydim + 1

    @property
    def net_out(self) -> int:
        return self.xdim

    @property
    def conditions_on_y(self) -> bool:
        """Whether the net takes y beside the diffused state (the CDE), or
        the diffused state already holds y (the CDiffE)."""
        return True

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        return nets.mlp_init(
            self.net_in, self.net_out, self.hidden_layers, generator=generator, device=device
        )

    def apply_a(self, params, z: Tensor, cond: Optional[Tensor], t) -> Tensor:
        """Learned drift a(z, cond, t); the net predicts g * score."""
        return nets.score_mlp_apply(params, z, cond, t)

    def diffusion_state(self, x: Tensor, y: Tensor):
        """(z0, cond): what is diffused and what conditions the net.  The
        CDE diffuses x conditioned on y."""
        return x, y

    def _draw_t_eps(self, generator: Optional[torch.Generator], z0: Tensor, t, eps):
        """(t, eps) for a loss, each drawn from ``generator`` unless given,
        t first (one ``torch.rand((..., 1))`` of z0's leading shape through
        ``sample_t``), then eps (normal, the shape of z0); both moved to
        z0's device.  z0 is a batch (B, dz) or an epoch's batches (nb, B,
        dz)."""
        gen_dev = generator.device if generator is not None else "cpu"
        if t is None:
            u = torch.rand((*z0.shape[:-1], 1), generator=generator, device=gen_dev)
            t = sample_t(self.sde, z0.shape[-2], u=u).to(z0.device)
        if eps is None:
            eps = torch.randn(z0.shape, generator=generator, device=gen_dev, dtype=z0.dtype).to(z0.device)
        return t, eps

    def make_loss_fn(
        self,
        cfg: LossConfig,
        initial_condition: Optional[Callable[[Tensor, Tensor], Tensor]] = None,
        forward_model: Optional[Callable[[Tensor], Tensor]] = None,
        forward_params: Optional[Dict[str, float]] = None,
    ):
        """loss(params, generator, x, y, *, t=None, eps=None, v=None) ->
        (scalar, info dict).

        Draws from ``generator``, in this order, whatever is not given: t
        (one ``torch.rand((batch, 1))`` through ``sample_t``), eps (normal,
        the shape of z0), and for a Hutchinson divergence the Rademacher
        probe v.  DSM draws no probe.  Passing t, eps and v (generator None)
        is the injection form the tests feed with another package's draws.
        ``loss_fn.draws(generator, x, y)`` is :meth:`loss_draws` for this
        loss as its keywords (:func:`loss_keywords`): what it would draw,
        for the epoch engines, which draw before the step
        (``train.make_epoch_fn``).  The DSM loss also has
        ``loss_fn.epoch_draws(generator, xb, yb)``, :meth:`epoch_draws` as
        its keywords: a whole epoch's t and eps in two calls, (nb, B, .),
        batch i's in row i.
        ``forward_model`` and ``forward_params`` are taken, as in the JAX
        package, so that every model is built alike; only the Posterior
        model's loss uses them.
        """
        if cfg.name not in ("DSM", "DSM_PDE", "PINNLoss", "PINNLoss2"):
            raise ValueError(f"unsupported loss {cfg.name!r} for {type(self).__name__}")
        base = self.sde.base
        hutchinson = _draws_probe(cfg)
        pde_kw = dict(pde_loss=cfg.pde_loss, pde_metric=cfg.pde_metric,
                      divergence_method=cfg.divergence_method)
        pinn_kw = dict(initial_condition=initial_condition, lam=cfg.lam, lam2=cfg.lam2,
                       ic_metric=cfg.ic_metric, **pde_kw)

        def loss_fn(params, generator: Optional[torch.Generator], x: Tensor, y: Tensor, *,
                    t: Optional[Tensor] = None, eps: Optional[Tensor] = None, v: Optional[Tensor] = None):
            z0, cond_y = self.diffusion_state(x, y)
            t, eps = self._draw_t_eps(generator, z0, t, eps)
            if cfg.name == "DSM":
                z_t = base.diffuse(t, z0, eps)
                cond = cond_y if self.conditions_on_y else None
                score = self.apply_a(params, z_t, cond, t) / base.g(t)
                return torch.mean(L.dsm_loss(score, base.std(t), eps)), {}
            if v is None and hutchinson:
                v = L.rademacher_like(z0.shape, generator, device=z0.device, dtype=z0.dtype)
            if cfg.name == "DSM_PDE":
                return L.dsm_pde_loss(self.apply_a, params, base, x, y, z0, eps, t, lam=cfg.lam, v=v, **pde_kw)
            fn = L.pinn_loss if cfg.name == "PINNLoss" else L.pinn2_loss
            return fn(self.apply_a, params, base, x, y, z0, eps, t, v=v, **pinn_kw)

        loss_fn.draws = lambda generator, x, y: loss_keywords(*self.loss_draws(cfg, generator, x, y))
        if cfg.name == "DSM":
            loss_fn.epoch_draws = lambda generator, xb, yb: loss_keywords(*self.epoch_draws(generator, xb, yb))
        return loss_fn

    def epoch_draws(self, generator: torch.Generator, xb: Tensor, yb: Tensor):
        """(t, eps) of the DSM loss for a whole epoch's batches (nb, B, .):
        one ``torch.rand((nb, B, 1))`` through ``sample_t``, then one
        ``torch.randn`` of z0's shape (nb, B, dz), on the generator's
        device.  Row i holds batch i's draws: the loss handed them computes
        its value for those draws.  This is the DSM stream of both epoch
        engines (``train.make_epoch_fn`` and the fused engine)."""
        z0, _ = self.diffusion_state(xb, yb)
        return self._draw_t_eps(generator, z0, None, None)

    def loss_draws(self, cfg: LossConfig, generator: Optional[torch.Generator], x: Tensor, y: Tensor):
        """(t, eps, v): what the loss of :meth:`make_loss_fn` draws from
        ``generator`` for the batch (x, y), in its order and shapes; v is
        None unless the loss draws a Hutchinson probe.  Handing them to the
        loss by its keywords gives the value it computes from the generator."""
        z0, _ = self.diffusion_state(x, y)
        t, eps = self._draw_t_eps(generator, z0, None, None)
        v = None
        if cfg.name != "DSM" and _draws_probe(cfg):
            v = L.rademacher_like(z0.shape, generator, device=z0.device, dtype=z0.dtype)
        return t, eps, v

    def sample(
        self,
        params,
        y: Optional[Tensor],
        num_samples: int = 2000,
        num_steps: int = 200,
        mean: float = 0.0,
        std: float = 1.0,
        generator: Optional[torch.Generator] = None,
        device=None,
        method: str = "auto",
        compute_dtype="auto",
    ) -> Tensor:
        """Posterior samples (num_samples, xdim) for the condition y (ydim,).

        method: 'auto' (the fused E-M kernel on a CUDA device, the plain
        Euler-Maruyama scan on the CPU), 'kernel', 'plain', 'heun' (the
        probability-flow ODE, ``samplers.heun_ode``) or
        'expint[:ode|:sde][:1|:2]' (``samplers.exponential_integrator``,
        SDE form of order 1 by default; num_steps + 1 net evaluations).
        The device is ``device``, else y's.  compute_dtype ('auto' =
        torch.bfloat16, or torch.float32) is the kernel's weight/activation
        dtype, each a kernel of its own on the card; its sums and state stay
        f32.  The other samplers compute in f32.
        """
        dev = _device_of(params, y, device)
        method = _resolve_method(method, dev)
        drift = lambda z, c, s: self.apply_a(params, z, c, s)
        common = dict(mean=mean, std=std, generator=generator, device=dev)
        if method == "heun":
            return samplers.heun_ode(self.sde, drift, y, num_samples, self.xdim, num_steps, **common)
        if method.startswith("expint"):
            ode, order = _expint_options(method)
            return samplers.exponential_integrator(self.sde, drift, y, num_samples, self.xdim, num_steps,
                                                   ode=ode, order=order, **common)
        if method == "plain":
            return samplers.euler_maruyama(self.sde, drift, y, num_samples, self.xdim, num_steps, **common)
        from ..ops.em_kernel import fused_em_sampler

        x0, seed = _kernel_draws(generator, num_samples, self.xdim, mean, std, dev)
        base = self.sde.base
        return fused_em_sampler(
            params, x0, y, num_steps, T=self.sde.T, beta_min=base.beta_min,
            beta_max=base.beta_max, seed=seed,
            compute_dtype=torch.bfloat16 if compute_dtype == "auto" else compute_dtype,
        )


@dataclasses.dataclass(frozen=True)
class CDE(DiffusionModel):
    """Conditional Denoising Estimator: score net on [x, y, t] -> xdim."""


@dataclasses.dataclass(frozen=True)
class CDiffE(DiffusionModel):
    """Conditional Diffusive Estimator: diffuses the joint z = [x, y].

    The net maps [z, t] -> xdim + ydim; the loss passes cond=None because
    the condition is part of the diffused state.
    """

    @property
    def net_out(self) -> int:
        return self.xdim + self.ydim

    @property
    def conditions_on_y(self) -> bool:
        return False

    def diffusion_state(self, x: Tensor, y: Tensor):
        return torch.cat([x, y], dim=-1), y

    def sample(
        self,
        params,
        y: Tensor,
        num_samples: int = 2000,
        num_steps: int = 200,
        mean: float = 0.0,
        std: float = 1.0,
        generator: Optional[torch.Generator] = None,
        device=None,
        method: str = "auto",
        compute_dtype="auto",
    ) -> Tensor:
        """Posterior samples (num_samples, xdim) for y (ydim,): each step
        re-diffuses y to T - t with fresh noise and advances the x block of
        the joint reverse SDE.  method: 'auto' (the fused CDiffE kernel on a
        CUDA device, the plain ``euler_maruyama_cdiffe`` on the CPU),
        'kernel' or 'plain'; no Heun or exponential integrator, as in the
        JAX package (the re-diffusion is SDE-specific).  compute_dtype as
        :meth:`DiffusionModel.sample`."""
        if method not in ("auto", "kernel", "plain"):
            raise ValueError(f"CDiffE sampler method {method!r} unsupported")
        dev = _device_of(params, y, device)
        if _resolve_method(method, dev) == "plain":
            return samplers.euler_maruyama_cdiffe(
                self.sde, lambda z, c, s: self.apply_a(params, z, c, s), y,
                num_samples, self.xdim, num_steps, mean=mean, std=std,
                generator=generator, device=dev,
            )
        from ..ops.em_kernel import fused_em_sampler_cdiffe

        x0, seed = _kernel_draws(generator, num_samples, self.xdim, mean, std, dev)
        base = self.sde.base
        return fused_em_sampler_cdiffe(
            params, x0, y, num_steps, T=self.sde.T, beta_min=base.beta_min,
            beta_max=base.beta_max, seed=seed,
            compute_dtype=torch.bfloat16 if compute_dtype == "auto" else compute_dtype,
        )


@dataclasses.dataclass(frozen=True)
class PosteriorDiffusionEstimator(DiffusionModel):
    """DPS model: prior net (x, t) + likelihood net (x, y, t), the scores
    summed and times g(t).  Params are {'prior': mlp, 'likelihood': mlp}.
    Trained with the PosteriorLoss (``losses.posterior_loss``) through the
    frozen forward model.  Sampling is the plain Euler-Maruyama scan, Heun
    or expint (the JAX package has no kernel for it either)."""

    def init(self, generator: Optional[torch.Generator] = None, device=None):
        prior = nets.mlp_init(self.xdim + 1, self.xdim, self.hidden_layers, generator=generator, device=device)
        lik = nets.mlp_init(self.net_in, self.xdim, self.hidden_layers, generator=generator, device=device)
        return {"prior": prior, "likelihood": lik}

    def apply_a(self, params, z: Tensor, cond: Optional[Tensor], t) -> Tensor:
        return nets.posterior_score_apply(params["prior"], params["likelihood"], self.sde.base.g, z, cond, t)

    def make_loss_fn(self, cfg: LossConfig, initial_condition=None, forward_model=None, forward_params=None):
        """loss(params, generator, x, y, *, t=None, eps=None) -> (scalar,
        {'PriorLoss', 'LikelihoodLoss'}): ``losses.posterior_loss`` through
        the batched ``forward_model`` with ``forward_params``' a and b.  t
        and eps are drawn as :meth:`DiffusionModel.make_loss_fn` draws
        them, or given."""
        if cfg.name != "PosteriorLoss":
            raise ValueError(f"PosteriorDiffusionEstimator trains with the PosteriorLoss; got {cfg.name!r}")
        if forward_model is None or forward_params is None:
            raise ValueError("PosteriorDiffusionEstimator requires the forward model")
        base = self.sde.base
        a, b = forward_params["a"], forward_params["b"]

        def loss_fn(params, generator: Optional[torch.Generator], x: Tensor, y: Tensor, *,
                    t: Optional[Tensor] = None, eps: Optional[Tensor] = None):
            t, eps = self._draw_t_eps(generator, x, t, eps)
            return L.posterior_loss(
                nets.prior_mlp_apply, nets.score_mlp_apply, params["prior"], params["likelihood"],
                base, forward_model, x, y, eps, t, a=a, b=b, lam=cfg.lam,
            )

        loss_fn.draws = lambda generator, x, y: loss_keywords(*self.loss_draws(cfg, generator, x, y))
        return loss_fn

    def loss_draws(self, cfg: LossConfig, generator: Optional[torch.Generator], x: Tensor, y: Tensor):
        """(t, eps, None): the PosteriorLoss draws t and eps for x, no probe."""
        t, eps = self._draw_t_eps(generator, x, None, None)
        return t, eps, None

    def sample(self, params, y: Optional[Tensor], num_samples: int = 2000, num_steps: int = 200,
               mean: float = 0.0, std: float = 1.0, generator: Optional[torch.Generator] = None,
               device=None, method: str = "auto", compute_dtype="auto") -> Tensor:
        method = _resolve_method(method, _device_of(params, y, device), kernel_ok=False)
        if method == "kernel":
            raise ValueError("the Posterior model has no sampling kernel; use method 'plain'")
        return super().sample(params, y, num_samples, num_steps, mean, std, generator, device, method)


@dataclasses.dataclass(frozen=True, eq=False)
class AnalyticGuidanceDPS:
    """DPS with analytic likelihood guidance (Chung & Kim's algorithm): the
    posterior score is prior_net(x_t, t) + grad_{x_t} log p(y | x_hat_0(x_t))
    through the frozen forward model, with no learned likelihood net.

    Wraps a :class:`PosteriorDiffusionEstimator` and uses its
    ``params['prior']``.  ``guidance``: 'dps' (Tweedie point estimate,
    ``losses.likelihood_score_target``) or 'pgdm' (variance-corrected,
    ``losses.pgdm_likelihood_score``).  ``guidance_clip`` caps each sample's
    guidance norm (None: no cap).  ``surrogate_weights``: the surrogate's
    (W, b) pairs; with them, sampling on a CUDA device runs the fused guided
    kernel (B5), which computes the surrogate's derivatives itself.
    Duck-types the model surface the evaluation harness needs (sde, xdim,
    apply_a, sample).
    """

    base_model: PosteriorDiffusionEstimator
    forward_model: Callable[[Tensor], Tensor]
    forward_params: Dict[str, float]
    guidance_clip: Optional[float] = 100.0
    guidance: str = "dps"
    surrogate_weights: Optional[tuple] = None

    @property
    def sde(self) -> ReverseSDE:
        return self.base_model.sde

    @property
    def xdim(self) -> int:
        return self.base_model.xdim

    @property
    def ydim(self) -> int:
        return self.base_model.ydim

    def apply_a(self, params, z: Tensor, cond: Tensor, t) -> Tensor:
        """g(t) (s_prior + clip(s_lik)); the derivatives are ``torch.func``
        transforms, so this also works under ``torch.no_grad``."""
        base = self.sde.base
        fp = self.forward_params
        t = nets._as_t_column(t, z.shape[0], z)
        s_prior = nets.prior_mlp_apply(params["prior"], z, t)
        if self.guidance == "pgdm":
            s_lik = L.pgdm_likelihood_score(
                nets.prior_mlp_apply, params["prior"], base, self.forward_model, z, cond, t, a=fp["a"], b=fp["b"])
        else:
            target = L.likelihood_score_target(
                nets.prior_mlp_apply, params["prior"], base, self.forward_model, z, cond, t,
                a=fp["a"], b=fp["b"], s_prior=s_prior)
            s_lik = target / base.mean_weight(t)
        if self.guidance_clip is not None:
            norm = torch.linalg.norm(s_lik, dim=-1, keepdim=True)
            s_lik = s_lik * torch.clamp(self.guidance_clip / (norm + 1e-12), max=1.0)
        return base.g(t) * (s_prior + s_lik)

    def sample(
        self,
        params,
        y: Tensor,
        num_samples: int = 2000,
        num_steps: int = 200,
        mean: float = 0.0,
        std: float = 1.0,
        generator: Optional[torch.Generator] = None,
        device=None,
        method: str = "auto",
    ) -> Tensor:
        """method: 'auto' (the fused guided kernel on a CUDA device when
        surrogate weights are given, else the plain scan), 'kernel' or
        'plain'.  No Heun variant: the clipped guidance is not a smooth ODE
        field."""
        if method not in ("auto", "kernel", "plain"):
            raise ValueError(f"AnalyticGuidanceDPS supports method 'auto', 'kernel' or 'plain', got {method!r}")
        kernel_ok = self.guidance in ("dps", "pgdm") and self.surrogate_weights is not None
        dev = _device_of(params, y, device)
        method = _resolve_method(method, dev, kernel_ok)
        if method == "plain":
            return samplers.euler_maruyama(
                self.sde, lambda z, c, s: self.apply_a(params, z, c, s), y,
                num_samples, self.xdim, num_steps, mean=mean, std=std,
                generator=generator, device=dev,
            )
        if not kernel_ok:
            raise ValueError(
                "method 'kernel' needs guidance 'dps' or 'pgdm' and surrogate_weights "
                "(the fused kernel computes the surrogate's derivatives itself)"
            )
        from ..ops.dps_kernel import fused_guided_em_sampler

        x0, seed = _kernel_draws(generator, num_samples, self.xdim, mean, std, dev)
        base = self.sde.base
        fp = self.forward_params
        return fused_guided_em_sampler(
            params["prior"], self.surrogate_weights, x0, y, a=fp["a"], b=fp["b"],
            guidance_clip=self.guidance_clip, num_steps=num_steps, T=self.sde.T,
            beta_min=base.beta_min, beta_max=base.beta_max, seed=seed, guidance=self.guidance,
        )
