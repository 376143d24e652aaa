"""The host side of the general route's training forward (#5s,
csrc/flash_full_fwd.cu, flash_full_stats_kernel), which runs only on the
card: its schedule by tile width (three serial consumers at tiles <= 64,
two in ping-pong at 128), its plan (q and key tiles, the persistent grid,
shared memory, the stats pitch) at the route's shapes, the register budgets
its setmaxnreg counts set, the constants the kernel shares with the plan,
the order of the persistent walk, and the consumers' loops: the serial
one's order of steps, and the ping-pong turns (every turn taken is passed,
in strict alternation, with no barrier left half-arrived)."""

import re

import pytest

from open_diffusiongs_tpu_torch.ops import _build, attention

H100_SMS = 132
SMEM_PER_BLOCK = 232448          # 227 KB of dynamic shared memory a block
REGS_PER_SM = 65536
WG = 128
TILES = (16, 32, 64, 128)

# (b, lq, lk, h, d) -> (tile, rows, n_q_tiles, n_key_tiles, tail_keys,
#                       tiles, grid)
PLANS = [
    ((4, 4098, 4098, 16, 64), (64, 192, 22, 33, 2, 1408, 132)),
    ((4, 4098, 4098, 16, 48), (64, 192, 22, 33, 2, 1408, 132)),
    ((4, 4098, 4098, 8, 128), (128, 128, 33, 33, 2, 1056, 132)),
    ((1, 4098, 4098, 8, 128), (128, 128, 33, 33, 2, 264, 132)),
    ((4, 3072, 4098, 16, 64), (64, 192, 16, 33, 2, 1024, 132)),  # 1026:4098
    ((4, 1026, 1026, 16, 64), (64, 192, 6, 9, 2, 384, 132)),  # the 2nd half
    ((2, 700, 700, 3, 40), (64, 192, 4, 6, 60, 24, 24)),
    ((2, 1100, 1100, 5, 20), (32, 192, 6, 9, 76, 60, 60)),
    ((3, 200, 200, 2, 8), (16, 192, 2, 2, 72, 12, 12)),
    ((1, 1, 3, 2, 64), (64, 192, 1, 1, 3, 2, 2)),     # one query, 3 keys
    ((1, 333, 333, 2, 100), (128, 128, 3, 3, 77, 6, 6)),
    ((1, 16386, 16386, 16, 64), (64, 192, 86, 129, 2, 1376, 132)),
]


@pytest.mark.parametrize("shape,want", PLANS)
def test_plan(shape, want):
    b, lq, lk, h, d = shape
    plan = attention.full_fwd_plan(b, lq, lk, h, d, H100_SMS)
    assert (plan.tile, plan.rows, plan.n_q_tiles, plan.n_key_tiles,
            plan.tail_keys, plan.tiles, plan.grid) == want
    assert plan.tile == attention.full_tile_width(d)
    sched = attention.full_fwd_schedule(plan.tile)
    assert plan.rows == 64 * sched.consumers
    keys = attention.FULL_FWD_KEYS
    assert plan.n_q_tiles * plan.rows >= lq > (plan.n_q_tiles - 1) * plan.rows
    assert 1 <= plan.tail_keys <= keys
    assert (plan.n_key_tiles - 1) * keys + plan.tail_keys == lk
    assert plan.grid == min(plan.tiles, H100_SMS)   # one CTA an SM
    assert plan.pitch == attention.stats_pitch(lq)


@pytest.mark.parametrize("tile", TILES)
def test_schedule(tile):
    """Three serial consumers below 128, two in ping-pong at 128; the ring
    as deep as shared memory holds."""
    sched = attention.full_fwd_schedule(tile)
    assert sched.pingpong == (tile == 128)
    assert sched.consumers == (2 if tile == 128 else 3)
    assert sched.stages == (3 if tile == 128 else 4)


@pytest.mark.parametrize("tile,smem", [(16, 40960), (32, 79872),
                                       (64, 157696), (128, 231424)])
def test_shared_memory_fits_a_block(tile, smem):
    """The q tile and the K / V ring of every tile width fit in a block's
    227 KB, with the ring's barriers and the alignment slack."""
    plan = attention.full_fwd_plan(1, 4098, 4098, 1, tile, H100_SMS)
    sched = attention.full_fwd_schedule(tile)
    tiles = 2 * tile * (plan.rows
                        + 2 * sched.stages * attention.FULL_FWD_KEYS)
    assert plan.smem_bytes == smem
    assert plan.smem_bytes >= tiles + 1024
    assert plan.smem_bytes % 1024 == 0
    assert plan.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("tile", TILES)
def test_register_budgets_fit_the_launch(tile):
    """setmaxnreg only moves the registers a CTA was launched with (one CTA
    an SM; ptxas gives each thread the launch bound, 65,536 / threads
    rounded down to a multiple of 8): the counts are multiples of 8 in
    [24, 256], and what the consumers add, the producer must give up, or
    their setmaxnreg.inc waits forever."""
    sched = attention.full_fwd_schedule(tile)
    n = sched.consumers
    for r in (sched.consumer_regs, sched.producer_regs):
        assert r % 8 == 0 and 24 <= r <= 256
    launch = REGS_PER_SM // ((n + 1) * WG) // 8 * 8
    assert launch == (168 if tile == 128 else 128)
    assert n * (sched.consumer_regs - launch) <= (launch
                                                  - sched.producer_regs)
    assert (n * sched.consumer_regs + sched.producer_regs) * WG <= REGS_PER_SM


def _source():
    return (_build.CSRC / "flash_full_fwd.cu").read_text()


def test_kernel_constants_match_the_plan():
    src = _source()
    sched = src[src.index("struct Sched {"):src.index("struct StatsSmem {")]
    wide, narrow = (attention.full_fwd_schedule(t) for t in (128, 64))
    assert "static constexpr bool PINGPONG = DH > 64;" in sched
    for name, field in (("NC", "consumers"), ("NST", "stages"),
                        ("REGS", "consumer_regs"),
                        ("PRODUCER_REGS", "producer_regs")):
        assert (f"static constexpr int {name} = PINGPONG ? "
                f"{getattr(wide, field)} : {getattr(narrow, field)};"
                in sched), name
    assert "static constexpr int SQ = NC * ROWS;" in sched
    assert "constexpr int ROWS = 64;" in src
    assert f"constexpr int BK = {attention.FULL_FWD_KEYS};" in src
    tau = re.search(r"constexpr float RESCALE_TAU = ([\d.]+)f;", src)
    assert float(tau.group(1)) == attention.FULL_FWD_RESCALE_TAU
    assert "setmaxnreg_inc<S::REGS>()" in src
    assert "setmaxnreg_dec<S::PRODUCER_REGS>()" in src
    assert "__launch_bounds__(Sched<DH>::THREADS, 1)" in src


def walk(plan) -> list:
    """The q tiles each CTA of the persistent grid takes, in its order, as
    flash_full_stats_kernel walks them: t = blockIdx.x, + gridDim.x, ..."""
    return [list(range(c, plan.tiles, plan.grid)) for c in range(plan.grid)]


@pytest.mark.parametrize("shape", [s for s, _ in PLANS])
def test_walk_covers_every_tile_once_and_balances(shape):
    b, lq, lk, h, d = shape
    plan = attention.full_fwd_plan(b, lq, lk, h, d, H100_SMS)
    ctas = walk(plan)
    seen = sorted(t for c in ctas for t in c)
    assert seen == list(range(plan.tiles))
    counts = {len(c) for c in ctas}
    assert max(counts) - min(counts) <= 1
    assert max(counts) == -(-plan.tiles // plan.grid)
    # (q tile, head, batch) of tile t, q tile fastest
    n_qt = plan.n_q_tiles
    coords = {(t % n_qt, t // n_qt % h, t // (n_qt * h))
              for t in range(plan.tiles)}
    assert coords == {(x, y, z) for x in range(n_qt) for y in range(h)
                      for z in range(b)}


def _body(name: str) -> str:
    src = _source()
    start = src.index(f"void {name}(")
    return src[start:src.index("\n}\n", start)]


def test_serial_consumer_loop():
    """A serial consumer runs each key tile as S (both operands in shared
    memory, the first product writing S without reading it), the max,
    exp2 with the split, P.V, every product waited for before the next
    step: no wgmma is issued or waited for under a runtime condition
    (ptxas would serialise them)."""
    body = _body("serial_consumer")
    assert body.count("wgmma_wait<0>();") == 2
    assert "wgmma_wait<1>" not in body and "turn" not in body
    loop = body[body.index("for (int j = 0; j < n_kt; ++j, ++it) {"):]
    order = [loop.index(x) for x in (
        "r.issue_s(", "r.new_max(", "r.rescale(", "r.exp_split();",
        "r.issue_pv(", "mbar_arrive(&s.empty[st]);")]
    assert order == sorted(order)
    src = _source()
    assert "Wgmma<BK>::template ss_init<0>(sacc," in src
    assert "ex2.approx.ftz.f32" in src


def turns(n_tiles: int, n_kt: int, wg: int) -> list:
    """Consumer wg's barrier operations over n_tiles tiles of n_kt key
    tiles, as pingpong_consumer runs them: consumer 1 first passes the turn
    to 0; every issue block (S_0; S_j with P_{j-1}.V_{j-1}; P_{n-1}.V_{n-1})
    takes its own turn and passes the other's, but consumer 1's last."""
    ops = [("arrive", 0)] if wg == 1 else []
    for t in range(n_tiles):
        for blk in range(n_kt + 1):
            ops.append(("sync", wg))
            ops.append(("issue", (t, blk)))
            if wg == 0 or t < n_tiles - 1 or blk < n_kt:
                ops.append(("arrive", 1 - wg))
    return ops


def run_turns(n_tiles: int, n_kt: int):
    """Named-barrier semantics over two consumers (barrier id: the consumer
    that syncs on it; count 2 x 128: one consumer syncs, the other
    arrives): the issue order, and the arrivals left pending."""
    progs = [turns(n_tiles, n_kt, w) for w in (0, 1)]
    pc = [0, 0]
    pending = [0, 0]        # arrivals on barrier b not yet matched
    order = []
    while pc[0] < len(progs[0]) or pc[1] < len(progs[1]):
        moved = False
        for w in (0, 1):
            if pc[w] >= len(progs[w]):
                continue
            op, arg = progs[w][pc[w]]
            if op == "sync":
                if not pending[arg]:
                    continue
                pending[arg] -= 1
            elif op == "arrive":
                pending[arg] += 1
                # two arrivals of one consumer would fill the barrier's
                # count of 256 without the other
                assert pending[arg] <= 1
            else:
                order.append((w, arg))
            pc[w] += 1
            moved = True
        if not moved:
            raise AssertionError(f"deadlock at {pc}")
    return order, pending


@pytest.mark.parametrize("n_tiles,n_kt", [(1, 1), (1, 2), (1, 33), (3, 1),
                                          (8, 33), (5, 9)])
def test_turns_alternate_and_balance(n_tiles, n_kt):
    order, pending = run_turns(n_tiles, n_kt)
    assert pending == [0, 0]
    assert [w for w, _ in order] == [0, 1] * (n_tiles * (n_kt + 1))
    for w in (0, 1):
        assert [blk for x, blk in order if x == w] == [
            (t, blk) for t in range(n_tiles) for blk in range(n_kt + 1)]


def test_turn_protocol_in_the_source():
    """The ping-pong consumer carries the protocol the model above checks."""
    body = _body("pingpong_consumer")
    assert "auto take_turn = [&] { bar_sync(BAR_TURN + wg, 2 * WG); };" in body
    assert ("auto pass_turn = [&] { bar_arrive(BAR_TURN + (wg ^ 1), 2 * WG); "
            "};") in body
    assert "if (wg == 1) pass_turn();" in body
    assert ("if (wg == 0 || t + (int)gridDim.x < p.n_tiles) pass_turn();"
            in body)
    assert body.count("take_turn();") == 3 and body.count("pass_turn();") == 4
