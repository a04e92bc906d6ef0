#!/usr/bin/env python3
"""Where the port's SAC update at the pixel recipe's shape parts from the
JAX package's on the CPU, and why: ``tests/test_torch_sac.py``'s ``recipe``
case (conv encoder, 2 cameras, ``obs_pool`` 2, hidden (100, 50), batch 32,
JAX's draws fed in) run once more, printing

- each parameter's relative gradient gap, port against JAX (the test's
  measure), where it passes 1e-2;
- the same gaps of JAX's and of the port's gradients against the port's
  update with its conv trunks in float32 (how far bfloat16 alone moves
  them);
- the largest parameter gap, in units of lr, after one and after two
  updates, per network.

    JAX_PLATFORMS=cpu python3 scripts/sac_recipe_update_probe.py   (~2 min)
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import test_torch_sac as T  # noqa: E402
from cartpoleplusplus_tpu_torch.models import trunks  # noqa: E402
from cartpoleplusplus_tpu_torch.utils.params import (  # noqa: E402
    critic_params_from_flax,
    gaussian_actor_params_from_flax,
)


def _grads(u) -> dict:
    return {**{"a." + k: p.grad.clone() for k, p in u.st.actor.named_parameters()},
            **{"c." + k: p.grad.clone() for k, p in u.st.critic.named_parameters()}}


def _rel(a, b) -> float:
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def _gaps_in_lr(u, actor_tree, critic_tree) -> dict:
    out = {}
    for name, module, tree, conv, lr in (
            ("actor", u.st.actor, actor_tree, gaussian_actor_params_from_flax, u.lr_a),
            ("critic", u.st.critic, critic_tree, critic_params_from_flax, u.lr_c)):
        want = conv(jax.device_get(tree))
        out[name] = max(float((v - want[k]).abs().max()) / lr for k, v in module.state_dict().items())
    return out


def main() -> int:
    u = T._one_update("recipe")
    jax_g = {**{"a." + k: v for k, v in gaussian_actor_params_from_flax(u.agrads).items()},
             **{"c." + k: v for k, v in critic_params_from_flax(u.cgrads).items()}}
    port_g = _grads(u)
    one = _gaps_in_lr(u, u.new_bundle[0], u.new_bundle[1])
    batch = T._batch(u.cfg, seed=1, b=u.b)
    key = jax.random.PRNGKey(14)
    bundle, _ = jax.jit(u.train_once)(u.new_bundle, tuple(jnp.asarray(x) for x in batch), key)
    u.port_once(u.st, tuple(T._t(x) for x in batch), **T._draws(key, u.hp, u.b))
    two = _gaps_in_lr(u, bundle[0], bundle[1])

    init = trunks.ConvTrunk.__init__

    def init_f32(self, *args, **kwargs):
        init(self, *args, **{**kwargs, "dtype": torch.float32})

    trunks.ConvTrunk.__init__ = init_f32
    try:
        f32_g = _grads(T._one_update("recipe"))
    finally:
        trunks.ConvTrunk.__init__ = init
    print("parameter | port vs JAX | JAX vs float32 port | port vs float32 port")
    for k in jax_g:
        gaps = (_rel(port_g[k], jax_g[k]), _rel(jax_g[k], f32_g[k]), _rel(port_g[k], f32_g[k]))
        if max(gaps) > 1e-2:
            print(k, *(f"{g:.4f}" for g in gaps), sep=" | ")
    print("largest gap in lr after one update:", {k: round(v, 3) for k, v in one.items()})
    print("largest gap in lr after two updates:", {k: round(v, 3) for k, v in two.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
