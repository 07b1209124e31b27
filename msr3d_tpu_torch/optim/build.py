"""Optimizers and learning-rate schedules with optax's arithmetic.

Counterpart of ``msr3d_tpu/optim/build.py`` (optax): the three schedules
as multiplicative factors of the base lr, evaluated at the count of
updates done so far (0 on the first step, as optax counts); ``AdamW``,
``Adam`` and ``SGD`` with optax's formulas; gradient clipping to a global
norm as ``optax.clip_by_global_norm`` computes it. The optimizer holds
state only for the parameters it is given (the trainable set), so the
frozen base never gets moments: the JAX package's trainable mask.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterable, List, Mapping, Optional, Tuple

import torch


def warmup_cosine(step, warmup_step, total_step):
    if step <= warmup_step:
        return step / max(warmup_step, 1)
    return max(0.5 * (1 + math.cos((step - warmup_step) / max(total_step - warmup_step, 1)
                                   * math.pi)), 1e-5)


def warmup_exp(step, warmup_step, total_step, gamma=0.9):
    if step <= warmup_step:
        return step / max(warmup_step, 1)
    return gamma ** (step * 1.0 / max(total_step - warmup_step, 1))


def warmup_cosine_instructblip(step, warmup_step, total_step):
    if step <= warmup_step:
        return 1e-3 + step / max(warmup_step, 1) * (1 - 1e-3)
    return 0.5 * (1 + math.cos((step - warmup_step) / max(total_step - warmup_step, 1) * math.pi))


SCHEDULES = {
    "warmup_cosine": warmup_cosine,
    "warmup_exp": warmup_exp,
    "warmup_cosine_instructblip": warmup_cosine_instructblip,
}


def make_schedule(name: str, base_lr: float, warmup_steps: int, total_steps: int,
                  **kw) -> Callable[[int], float]:
    fn = SCHEDULES[name]
    return lambda step: base_lr * fn(step, warmup_steps, total_steps, **kw)


def global_norm(grads: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    return torch.sqrt(sum(g.float().square().sum() for g in grads))


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float,
                        norm: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """optax's ``clip_by_global_norm``: unchanged while ``‖g‖ < max_norm``,
    else ``(g / ‖g‖) · max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``)."""
    norm = global_norm(grads) if norm is None else norm
    if bool(norm < max_norm):
        return grads
    return [g / norm.to(g.dtype) * max_norm for g in grads]


class Optimizer:
    """One optax-style update rule over named parameters, updated in place
    (the JAX package returns new arrays; the port saves the copy).

    ``step(grads)`` applies one update with ``lr = schedule(count)`` and
    increments ``count``.
    """

    kind = ""

    def __init__(self, params: Mapping[str, torch.nn.Parameter],
                 schedule: Callable[[int], float]):
        self.params = dict(params)
        self.schedule = schedule
        self.count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}

    def _update(self, name: str, param: torch.Tensor, grad: torch.Tensor,
                lr: float) -> None:
        raise NotImplementedError

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor]) -> None:
        lr = self.schedule(self.count)
        self.count += 1  # optax increments before the bias correction
        for name, param in self.params.items():
            self._update(name, param, grads[name].to(param.dtype), lr)

    def state_dict(self) -> Dict[str, Any]:
        return {"kind": self.kind, "count": self.count,
                "state": {n: dict(s) for n, s in self.state.items()}}

    def load_state_dict(self, state: Mapping[str, Any]) -> None:
        if state["kind"] != self.kind:
            raise ValueError(f"optimizer state of {state['kind']!r}, not {self.kind!r}")
        self.count = int(state["count"])
        self.state = {n: {k: v.to(self.params[n].device) for k, v in s.items()}
                      for n, s in state["state"].items()}


class Adam(Optimizer):
    """optax ``scale_by_adam``: ``m ← b1·m + (1-b1)·g``, ``v ← b2·v +
    (1-b2)·g²``, update ``m̂ / (√v̂ + ε)`` with ε outside the root; AdamW adds
    the decoupled decay ``wd·p`` before scaling by ``-lr``."""

    kind = "adam"

    def __init__(self, params, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0):
        super().__init__(params, schedule)
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay

    def _direction(self, name, param, grad):
        """``m̂ / (√v̂ + ε)`` plus the decoupled decay ``wd·p``."""
        st = self.state.setdefault(
            name, {"mu": torch.zeros_like(param), "nu": torch.zeros_like(param)}
        )
        mu = st["mu"].mul_(self.b1).add_((1 - self.b1) * grad)
        nu = st["nu"].mul_(self.b2).add_((1 - self.b2) * grad.square())
        mu_hat = mu / (1 - self.b1 ** self.count)
        nu_hat = nu / (1 - self.b2 ** self.count)
        update = mu_hat / (nu_hat.sqrt() + self.eps)
        if self.weight_decay:
            update = update + self.weight_decay * param
        return update

    def _update(self, name, param, grad, lr):
        param.add_(self._direction(name, param, grad) * -lr)


class AdamW(Adam):
    kind = "adamw"


class Lamb(Adam):
    """optax ``lamb``: the Adam direction with ε 1e-6 and the decoupled
    decay, scaled per parameter tensor by the trust ratio ``‖p‖ / ‖u‖`` (1
    where either norm is 0), then by ``-lr``."""

    kind = "lamb"

    def __init__(self, params, schedule, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-6, weight_decay: float = 0.0):
        super().__init__(params, schedule, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)

    def _update(self, name, param, grad, lr):
        update = self._direction(name, param, grad)
        param_norm, update_norm = param.norm(), update.norm()
        trust = torch.where((param_norm == 0) | (update_norm == 0),
                            torch.ones_like(param_norm), param_norm / update_norm)
        param.add_(update * trust * -lr)


class SGD(Optimizer):
    """optax ``sgd``: with momentum ``t ← g + momentum·t``, update ``-lr·t``."""

    kind = "sgd"

    def __init__(self, params, schedule, momentum: float = 0.0):
        super().__init__(params, schedule)
        self.momentum = momentum

    def _update(self, name, param, grad, lr):
        st = self.state.setdefault(name, {"trace": torch.zeros_like(param)})
        trace = st["trace"].mul_(self.momentum).add_(grad)
        param.add_(trace * -lr)


def build_optim(cfg: Mapping[str, Any], total_steps: int,
                params: Mapping[str, torch.nn.Parameter]
                ) -> Tuple[Optimizer, Callable[[int], float], Optional[float]]:
    """``cfg`` is the full config (the YAML's keys). Returns (optimizer over
    ``params``, schedule, clipping norm or None)."""
    solver = cfg["solver"]
    name = solver["optim"]["name"]
    args = dict(solver["optim"].get("args", {}))
    lr = float(args.pop("lr"))
    sched_args = dict(solver["sched"].get("args", {}))
    warmup = int(sched_args.pop("warmup_steps"))
    schedule = make_schedule(solver["sched"]["name"], lr, warmup, total_steps, **sched_args)
    if name in ("AdamW", "Adam"):
        b1, b2 = args.pop("betas", [0.9, 0.999])
        if name == "AdamW":
            opt = AdamW(params, schedule, b1=b1, b2=b2, eps=args.pop("eps", 1e-8),
                        weight_decay=args.pop("weight_decay", 0.0))
        else:
            opt = Adam(params, schedule, b1=b1, b2=b2)
    elif name == "SGD":
        opt = SGD(params, schedule, momentum=args.pop("momentum", 0.0))
    elif name == "Lamb":  # betas and eps keep optax's defaults, as in JAX
        opt = Lamb(params, schedule, weight_decay=args.pop("weight_decay", 0.0))
    else:
        raise ValueError(f"unknown optimizer {name!r}")
    grad_norm = solver.get("grad_norm")
    return opt, schedule, float(grad_norm) if grad_norm else None
