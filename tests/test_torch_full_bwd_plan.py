"""The host side of the general route's one-pass attention backward (#5b,
csrc/flash_full_bwd.cu), which runs only on the card: its plan (tile,
query step, query tiles, key blocks, persistent groups, grid, the dQ
accumulator and counters, the stats pitch), the order its CTAs take their
items in (the deterministic dQ order waits only on lower slots), and the
buffers the wrapper allocates, at the route's shapes: lq != lk, d 8 / 20 /
40 / 48 / 64 / 128 and one query over three keys."""

import pytest
import torch

from open_diffusiongs_tpu_torch.ops import attention

H100_SMS = 132

# (b, lq, lk, h, d) -> (tile, q_step, n_q_tiles, n_key_blocks, groups)
PLANS = [
    ((4, 4098, 4098, 16, 64), (64, 64, 65, 33, 4)),
    ((4, 4098, 4098, 16, 48), (64, 64, 65, 33, 4)),
    ((4, 4098, 4098, 8, 128), (128, 32, 129, 33, 4)),
    ((4, 3072, 4098, 16, 64), (64, 64, 48, 33, 4)),     # queries 1026:4098
    ((4, 1026, 1026, 16, 64), (64, 64, 17, 9, 14)),     # subset's 2nd half
    ((2, 700, 700, 3, 40), (64, 64, 11, 6, 6)),
    ((2, 1100, 1100, 5, 20), (32, 64, 18, 9, 10)),
    ((3, 200, 200, 2, 8), (16, 64, 4, 2, 6)),
    ((1, 1, 3, 2, 64), (64, 64, 1, 1, 2)),              # one query, 3 keys
    ((1, 3, 1, 2, 96), (128, 32, 1, 1, 2)),
    ((1, 16386, 16386, 16, 64), (64, 64, 257, 129, 1)),
    ((1, 20000, 20000, 2, 64), (64, 64, 313, 157, 1)),  # more blocks than SMs
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_plan(shape, want):
    b, lq, lk, h, d = shape
    plan = attention.full_bwd_plan(b, lq, lk, h, d, H100_SMS)
    tile, q_step, n_qt, n_kb, groups = want
    assert (plan.tile, plan.q_step, plan.n_q_tiles, plan.n_key_blocks,
            plan.groups) == want
    assert plan.tile == attention.full_tile_width(d)
    assert plan.grid == groups * n_kb
    assert plan.grid <= max(H100_SMS, n_kb)     # persistent: one CTA an SM
    assert plan.acc_shape == (b * h, n_qt * q_step, tile)
    assert plan.n_q_tiles * q_step >= lq > (plan.n_q_tiles - 1) * q_step
    assert n_kb * attention.FULL_BWD_KEYS >= lk
    assert plan.counters == b * h * n_qt + 1    # a counter a tile, a ticket
    assert plan.pitch == attention.stats_pitch(lq) and plan.pitch % 4 == 0


def schedule(plan, bh: int) -> list:
    """The (batch·head, key block) items of each CTA slot in the order the
    slot runs them, as csrc/flash_full_bwd.cu's CTAs take them: slot s =
    group·n_key_blocks + key block (from the ticket) runs heads group,
    group + groups, ..."""
    return [[(x, s % plan.n_key_blocks)
             for x in range(s // plan.n_key_blocks, bh, plan.groups)]
            for s in range(plan.grid)]


@pytest.mark.parametrize("shape", [s for s, _ in PLANS])
def test_schedule_waits_only_on_lower_slots(shape):
    """Every (head, key block) runs exactly once; a slot runs its heads in
    increasing order; the item each one's dQ waits on, (head, kb - 1),
    belongs to the slot just below it, which has started first."""
    b, lq, lk, h, d = shape
    plan = attention.full_bwd_plan(b, lq, lk, h, d, H100_SMS)
    sched = schedule(plan, b * h)
    assert len(sched) == plan.grid
    slot_of = {}
    for s, items in enumerate(sched):
        assert [x for x, _ in items] == sorted(x for x, _ in items)
        for item in items:
            assert item not in slot_of
            slot_of[item] = s
    assert sorted(slot_of) == [(x, kb) for x in range(b * h)
                               for kb in range(plan.n_key_blocks)]
    for (x, kb), s in slot_of.items():
        if kb:
            assert slot_of[(x, kb - 1)] == s - 1


@pytest.mark.parametrize("n_sm", [1, 8, 33, 114, 132])
def test_groups_fit_the_card(n_sm):
    plan = attention.full_bwd_plan(4, 4098, 4098, 16, 64, n_sm)
    assert plan.groups == max(1, n_sm // 33)
    assert plan.grid <= max(n_sm, 33)


@pytest.mark.parametrize("d,dm", [(64, 64), (48, 48), (40, 40), (128, 128),
                                  (20, 32), (8, 8)])
def test_scratch(d, dm):
    """The wrapper's buffers: q~ at the columns the maps read (dm: d for
    views TMA takes, the tile for the padded copies of d = 20), delta in the
    lse's [b, h, pitch] layout, int32 counters and the f32 accumulator."""
    b, lq, lk, h = 2, 300, 170, 3
    qkv = torch.zeros((b, lq, 3 * h * d), dtype=torch.bfloat16)
    _, k, v = (x.reshape(b, lq, h, d) for x in qkv.chunk(3, dim=-1))
    do = torch.zeros((b, lq, h, d), dtype=torch.bfloat16)
    ops, width = attention._full_operands(k[:, :lk], v[:, :lk], do)
    assert width == dm
    plan = attention.full_bwd_plan(b, lq, lk, h, d, H100_SMS)
    qs, delta, counters, acc = attention._full_bwd_scratch(
        plan, b, lq, h, width, "cpu")
    assert qs.shape == (b, lq, h, dm) and qs.dtype == torch.bfloat16
    assert qs.is_contiguous()
    assert attention.full_takes_view(qs.data_ptr(), qs.shape, qs.stride(),
                                     2) or dm * 2 % 16
    assert delta.shape == (b, h, attention.stats_pitch(lq))
    assert delta.dtype == torch.float32
    assert counters.shape == (plan.counters,)
    assert counters.dtype == torch.int32
    assert acc.shape == plan.acc_shape and acc.dtype == torch.float32


def test_cpu_tensors_take_the_plain_twin():
    """On CPU tensors the wrapper is its plain version, output for output."""
    g = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn((2, 9, 3, 20), generator=g) for _ in range(3))
    o, lse = attention.flash_full_mha_stats(q, k, v)
    do = torch.randn((2, 9, 3, 20), generator=g)
    for got, want in zip(attention.flash_full_mha_bwd(q, k, v, o, do, lse),
                         attention.flash_full_mha_bwd_ref(q, k, v, o, do,
                                                          lse)):
        assert torch.equal(got, want)
