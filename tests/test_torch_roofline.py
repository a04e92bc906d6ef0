"""The card's op-rate probe (the plain version of kernel K6) against the
JAX package's ``measure_vpu`` in scripts/roofline.py, on the CPU.

The op counts per element per iteration are the JAX probe's.  The plain
chains, run for a few iterations, equal the bodies of
scripts/roofline.py:112-149 evaluated op by op with ``jnp`` (measured:
equal), with the approximate reciprocal of ``recip_f32`` taken exactly on
both sides.  The fused plain chains, which the card's parity check holds
the kernel against, round each multiply-add once (checked here against
exact rational arithmetic), and from :func:`roofline.varied` every chain
moves far more than that check's tolerance.  ``measure_vpu`` times the
kernel and needs the card.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cartpoleplusplus_tpu_torch import kernels
from cartpoleplusplus_tpu_torch.utils import roofline


def _mix(v, scale, shift, floor):
    a = v * scale
    b = v + shift
    return jnp.maximum(jnp.where(b > a, a, b), floor)


JAX_BODIES = {
    "fma_f32": (2, lambda v: v * 1.0000001 + 1e-7),
    "fma_bf16": (2, lambda v: v * jnp.bfloat16(1.001) + jnp.bfloat16(1e-3)),
    "mix_f32": (5, lambda v: _mix(v, 1.0000001, 1e-7, 0.5)),
    "mix_bf16": (5, lambda v: _mix(v, jnp.bfloat16(1.001), jnp.bfloat16(1e-3), jnp.bfloat16(0.5))),
    "recip_f32": (3, lambda v: (1.0 / v) * 1.0000001 + 1.0),
    "div_f32": (3, lambda v: 1.0000001 / v + 1.0),
}


def test_chains_and_op_counts_match_jax():
    assert list(roofline.CHAINS) == list(JAX_BODIES)
    assert [roofline.CHAINS[m][1] for m in roofline.CHAINS] == [2, 2, 5, 5, 3, 3]
    assert roofline.SHAPE == (512, 1280)
    assert all("roofline_" + m in kernels.LAUNCHES for m in roofline.CHAINS)


@pytest.mark.parametrize("mix", list(JAX_BODIES))
def test_plain_chain_matches_jax_body(mix):
    """Seven iterations from varied starting values, equal to JAX's."""
    jdt = jnp.bfloat16 if "bf16" in mix else jnp.float32
    start = np.linspace(0.5, 3.0, 64, dtype=np.float32).reshape(8, 8)
    v = jnp.asarray(start).astype(jdt)
    x = torch.from_numpy(start).to(roofline.CHAINS[mix][2])
    for _ in range(7):
        v = JAX_BODIES[mix][1](v)
    got = roofline.run_chain(mix, x, 7)
    assert got.dtype == roofline.CHAINS[mix][2]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(v.astype(jnp.float32)))


@pytest.mark.parametrize("mix", list(JAX_BODIES))
def test_chain_from_the_probe_block_stays_finite(mix):
    """The probe's own start (every element 1.001) through 200 iterations:
    the chain neither overflows nor collapses, and on the CPU it runs the
    plain version and launches nothing."""
    kernels.reset_launches()
    x = roofline.initial(mix, (4, 8))
    assert x.dtype == roofline.CHAINS[mix][2] and bool((x.float() >= 1.0).all())
    out = roofline.run_chain(mix, x, 200).float()
    assert bool(torch.isfinite(out).all()) and bool((out > 0.49).all()) and bool((out < 2.0).all())
    assert kernels.LAUNCHES["roofline_" + mix] == 0


def _round_f32(r: Fraction) -> np.float32:
    """The float32 nearest to ``r``, ties to even."""
    c = np.float32(float(r))
    cands = [np.nextafter(c, np.float32(-np.inf)), c, np.nextafter(c, np.float32(np.inf))]
    dist = [abs(Fraction(float(x)) - r) for x in cands]
    best = min(dist)
    near = [x for x, d in zip(cands, dist) if d == best]
    return min(near, key=lambda x: int(np.float32(x).view(np.uint32)) & 1)


@pytest.mark.parametrize("mix", ["fma_f32", "recip_f32"])
def test_fused_step_rounds_once(mix):
    """One fused step equals v·s + c (or (1/v)·s + 1) computed exactly and
    rounded once to float32, on 256 starting values."""
    x = roofline.varied(mix, (16, 16))
    got = roofline.plain_chain(mix, x, 1, fused=True).numpy()
    s = Fraction(float(np.float32(1.0000001)))
    c = Fraction(float(np.float32(1e-7)))
    for v, g in zip(x.numpy().ravel(), got.ravel()):
        if mix == "fma_f32":
            want = _round_f32(Fraction(float(v)) * s + c)
        else:
            want = _round_f32(Fraction(float(np.float32(1.0) / v)) * s + 1)
        assert g == want, (v, g, want)


def test_fused_bf16_chain_equals_the_plain_one():
    """bfloat16 rounds the scale 1.001 to 1, so the product is exact and
    one rounding or two give the same chain."""
    x = roofline.varied("fma_bf16", (8, 8))
    assert torch.equal(roofline.plain_chain("fma_bf16", x, 40, fused=True),
                       roofline.plain_chain("fma_bf16", x, 40))


@pytest.mark.parametrize("mix", list(JAX_BODIES))
def test_chain_from_varied_start_moves(mix):
    """From the varied block every element of the fma and mix chains moves
    in 256 iterations, by at least 64 ulp at the top of its range in the
    largest; recip and div run to their fixed point."""
    x = roofline.varied(mix, (8, 8))
    moved = (roofline.plain_chain(mix, x, 256, fused=True).float() - x.float()).abs()
    ulp_top = 2.0**-23 if x.dtype == torch.float32 else 2.0**-9
    if mix.startswith(("fma", "mix")):
        assert bool((moved > 0).all())
        assert float(moved.max()) > 64 * ulp_top
    else:
        assert float(moved.max()) > 0.5


def test_run_chain_rejects_a_wrong_dtype():
    with pytest.raises(ValueError, match="expected"):
        roofline.run_chain("fma_bf16", torch.ones(4, 8), 3)


def test_measure_vpu_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        roofline.measure_chain("fma_f32", device="cpu")
