"""How K6 (csrc/roofline.cu) divides the probe's block over the card, and
how a chain's bound is priced, on the CPU.

``roofline.split`` mirrors the kernel's ``geometry``: one wave of
``blocks_per_sm`` blocks on every SM, each thread carrying K units (4, and
3 for div_f32; bfloat16 chains work in pairs), the slots past the whole
rounds spread over the blocks in runs of equal length.  Every unit is held
exactly once, and no SM holds more than 1 % above the mean share of units
whichever blocks land on it, at the card's 132 SMs, a 114-SM part and one
SM, at the probe's block and at a small odd one.  The chains run in that division
(``roofline.interleaved_chain``) give exactly the fused plain chains.
``roofline.issue_bound`` prices three loop bodies at known rates.
"""

import pytest
import torch

from cartpoleplusplus_tpu_torch.utils import roofline

# The most blocks of THREADS an SM holds under the kernel's register
# ceilings (16 blocks of THREADS for every chain but mix_bf16, 12).
MAX_BLOCKS = 16
SHAPES = {"fma_f32": [(512, 1280), (131, 257)], "mix_bf16": [(512, 1280), (131, 258)],
          "div_f32": [(512, 1280)]}
CASES = [(mix, shape, sms) for mix, shapes in SHAPES.items() for shape in shapes
         for sms in (132, 114, 1)]


@pytest.mark.parametrize("mix, shape, sms", CASES)
def test_split_covers_every_unit_once_and_balances_the_sms(mix, shape, sms):
    n = shape[0] * shape[1]
    units = roofline.units_of(mix, n)
    assert units == (n // 2 if mix.endswith("bf16") else n)
    geo = roofline.split(units, sms, MAX_BLOCKS, roofline.CHAINS_PER_THREAD[mix])
    assert geo["grid"] == sms * geo["blocks_per_sm"] and 1 <= geo["blocks_per_sm"] <= MAX_BLOCKS
    idx = roofline.slot_units(geo)
    k = geo["k"]
    assert idx.shape == (-(-geo["slots"] // k) * k, geo["grid"] * geo["threads"])
    live = idx >= 0
    assert torch.equal(idx[live].sort().values, torch.arange(units))
    # An SM holds blocks_per_sm blocks, whichever they are: its share is at
    # most that many of the largest block's.
    per_block = live.reshape(idx.shape[0], geo["grid"], geo["threads"]).sum((0, 2))
    assert int(per_block.max()) - int(per_block.min()) <= 1
    worst = geo["blocks_per_sm"] * int(per_block.max())
    assert worst <= 1.01 * units / sms
    # Whole rounds are coalesced: slot j of thread t holds unit j·T + t.
    t = torch.arange(idx.shape[1])
    for j in range(geo["full"]):
        assert torch.equal(idx[j], j * idx.shape[1] + t)


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("mix", list(roofline.CHAINS))
def test_interleaved_chains_equal_the_plain_chain(mix, sms):
    shape = (131, 258) if mix.endswith("bf16") else (131, 257)
    x = roofline.varied(mix, shape)
    got = roofline.interleaved_chain(mix, x, 25, sms, MAX_BLOCKS)
    want = roofline.plain_chain(mix, x, 25, fused=True)
    as_int = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    assert got.dtype == x.dtype and torch.equal(got.view(as_int), want.view(as_int))
    assert not torch.equal(want, x)


H100_SMS, H100_CLOCK = 132, 1.98e9


@pytest.mark.parametrize("body, bound_by, el_iter_per_clock_per_sm, unpriced", [
    # FFMA only: one warp instruction per clock per scheduler, 2 ops each,
    # the published 67 TFLOP/s float32 rate.
    ({"FFMA": 1}, "issue", 128, []),
    # MUFU + FFMA: the reciprocal's 16 per clock per SM binds.
    ({"MUFU": 1, "FFMA": 1}, "mufu rcp/rsqrt/lg2/ex2/sin/cos", 16, []),
    # The five-instruction mix: FMUL, FADD, FSETP, FSEL, FMNMX issue-bound;
    # the select has no row of its own and is priced at the FFMA rate.
    ({"FMUL": 1, "FADD": 1, "FSETP": 1, "FSEL": 1, "FMNMX": 1}, "issue", 128 / 5, ["FSEL"]),
])
def test_issue_bound_prices_known_bodies(body, bound_by, el_iter_per_clock_per_sm, unpriced):
    got = roofline.issue_bound(body, H100_SMS, H100_CLOCK)
    assert got["bound_by"] == bound_by and got["unpriced"] == unpriced
    want = H100_SMS * H100_CLOCK * el_iter_per_clock_per_sm
    assert got["el_iter_per_s"] == pytest.approx(want, rel=1e-12)
    if body == {"FFMA": 1}:
        assert 2 * got["el_iter_per_s"] == pytest.approx(66.9e12, rel=1e-3)
    if "MUFU" in body:
        assert 3 * got["el_iter_per_s"] == pytest.approx(12.5e12, rel=1e-2)
