"""The agents' optimizer: optax's ``adam`` on ``torch._foreach_*`` ops, and
the schedule that sets its learning rate before each update.

``Adam`` computes the update ``torch.optim.Adam`` computes at its defaults
(β 0.9/0.999, ε 1e-8 added outside the square root, bias correction; the
optax update), bit for bit, without ``torch.optim.Optimizer``: that class's
first ``add_param_group`` imports ``torch._dynamo``, seconds of start-up
in every process that builds an optimizer.  ``Schedule`` is
``torch.optim.lr_scheduler.LambdaLR`` for it.  Both keep their torch
counterparts' ``state_dict`` layout, so checkpoints written with either
restore into the other.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch

# The hyperparameters torch.optim.Adam records per group besides lr, betas
# and eps; kept so the state_dict has its layout.
_GROUP_DEFAULTS = dict(weight_decay=0, amsgrad=False, maximize=False, foreach=None,
                       capturable=False, differentiable=False, fused=None,
                       decoupled_weight_decay=False)


class Adam:
    """Adam over ``params`` (one group), updated in place by :meth:`step`.

    Per parameter, lazily at its first update: ``step`` (a float32 scalar
    on the CPU), ``exp_avg`` and ``exp_avg_sq`` (zeros like the
    parameter).  Each update, over the parameters that have a gradient:
    ``exp_avg ← lerp(exp_avg, g, 1 − β1)``, ``exp_avg_sq ← β2·exp_avg_sq +
    (1 − β2)·g²``, ``p ← p − lr/(1 − β1ᵗ) · exp_avg / (sqrt(exp_avg_sq) /
    sqrt(1 − β2ᵗ) + ε)``, in the operations and order of torch's.
    ``param_groups[0]["lr"]`` is read at each update.
    """

    def __init__(self, params: Iterable[torch.Tensor], lr: float = 1e-3,
                 betas: tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        self.param_groups = [dict(lr=lr, betas=betas, eps=eps, **_GROUP_DEFAULTS,
                                  params=list(params))]
        self.state: dict[torch.Tensor, dict] = {}

    def _params(self) -> list[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self._params():
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    @torch.no_grad()
    def step(self) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if p not in self.state:
                    self.state[p] = {
                        "step": torch.tensor(0.0, dtype=torch.float32),
                        "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                        "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format),
                    }
            beta1, beta2 = group["betas"]
            lr, eps = group["lr"], group["eps"]
            grads = [p.grad for p in params]
            states = [self.state[p] for p in params]
            steps = [s["step"] for s in states]
            exp_avgs = [s["exp_avg"] for s in states]
            exp_avg_sqs = [s["exp_avg_sq"] for s in states]
            torch._foreach_add_(steps, 1.0)
            torch._foreach_lerp_(exp_avgs, grads, 1 - beta1)
            torch._foreach_mul_(exp_avg_sqs, beta2)
            torch._foreach_addcmul_(exp_avg_sqs, grads, grads, 1 - beta2)
            counts = [s.item() for s in steps]
            step_size = [(lr / (1 - beta1 ** t)) * -1 for t in counts]
            bias_correction2_sqrt = [(1 - beta2 ** t) ** 0.5 for t in counts]
            denom = torch._foreach_sqrt(exp_avg_sqs)
            torch._foreach_div_(denom, bias_correction2_sqrt)
            torch._foreach_add_(denom, eps)
            torch._foreach_addcdiv_(params, exp_avgs, denom, step_size)

    def state_dict(self) -> dict:
        """``torch.optim.Adam``'s layout: ``state`` by parameter index (live
        references), ``param_groups`` with the indices as ``params``."""
        index = {p: i for i, p in enumerate(self._params())}
        groups, start = [], 0
        for g in self.param_groups:
            groups.append({**{k: v for k, v in g.items() if k != "params"},
                           "params": list(range(start, start + len(g["params"])))})
            start += len(g["params"])
        return {"state": {index[p]: s for p, s in self.state.items()}, "param_groups": groups}

    def load_state_dict(self, sd: dict) -> None:
        """Restore :meth:`state_dict`'s contents (or ``torch.optim.Adam``'s):
        the moments onto each parameter's device and dtype (a tensor
        already there is kept, not copied, as torch keeps it), ``step`` on
        the CPU, and each group's hyperparameters."""
        params = self._params()
        self.state = {}
        for i, s in sd["state"].items():
            p = params[int(i)]
            self.state[p] = {
                "step": torch.as_tensor(s["step"], dtype=torch.float32).cpu(),
                "exp_avg": s["exp_avg"].to(device=p.device, dtype=p.dtype),
                "exp_avg_sq": s["exp_avg_sq"].to(device=p.device, dtype=p.dtype),
            }
        for g, saved in zip(self.param_groups, sd["param_groups"]):
            g.update({k: v for k, v in saved.items() if k != "params"})


class Schedule:
    """The learning rate of ``opt`` as a function of its update count
    (``torch.optim.lr_scheduler.LambdaLR`` for :class:`Adam`): ``lr =
    base · fn(count)``, set at construction (count 0) and by each
    :meth:`step` after an update."""

    def __init__(self, opt: Adam, fn: Callable[[int], float]):
        self.optimizer, self.fn = opt, fn
        for g in opt.param_groups:
            g.setdefault("initial_lr", g["lr"])
        self.base_lrs = [g["initial_lr"] for g in opt.param_groups]
        self.last_epoch = -1
        self.step()

    def step(self) -> None:
        self.last_epoch += 1
        for g, base in zip(self.optimizer.param_groups, self.base_lrs):
            g["lr"] = base * self.fn(self.last_epoch)

    def state_dict(self) -> dict:
        """``LambdaLR``'s layout."""
        return {"base_lrs": list(self.base_lrs), "last_epoch": self.last_epoch,
                "_step_count": self.last_epoch + 1, "_is_initial": False,
                "_get_lr_called_within_step": False,
                "_last_lr": [g["lr"] for g in self.optimizer.param_groups],
                "lr_lambdas": [None]}

    def load_state_dict(self, sd: dict) -> None:
        """Take the saved count and base rates; the optimizer's own
        state_dict restores its current rate, as with ``LambdaLR``."""
        self.last_epoch = int(sd["last_epoch"])
        self.base_lrs = list(sd["base_lrs"])
