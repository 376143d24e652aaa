"""The port's CUDA launch functions against their ctypes signatures, and the
host-side rules of the attention wrappers (CPU only): TMA's alignment rule,
the packed backward's stats layout, q~'s rounding, and which [b, l, h, d]
views the general-route kernel reads as they lie.

`ops/_build.py::SIGNATURES` tells ctypes the argument types of every
`extern "C" int odgs_*` function in `open_diffusiongs_tpu_torch/csrc/*.cu`.
A signature that drifts from its prototype passes a pointer or a 64-bit
stride as a 32-bit int and cuts it silently, so each prototype is parsed
and its arity and argument kinds held against the table: pointer ->
c_void_p, `int` -> c_int, `long long` -> c_longlong, `float` -> c_float.
"""

import ctypes
import re

import pytest
import torch

from open_diffusiongs_tpu_torch.ops import _build, attention

PROTO = re.compile(r'extern\s+"C"\s+int\s+(odgs_\w+)\s*\(([^)]*)\)', re.S)


def _kind(param: str):
    """The ctypes type a C parameter declaration must be passed as."""
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    if re.match(r"(const\s+)?long\s+long\b", decl):
        return ctypes.c_longlong
    if re.match(r"(const\s+)?float\b", decl):
        return ctypes.c_float
    if re.match(r"(const\s+)?int\b", decl):
        return ctypes.c_int
    raise AssertionError(f"unclassified C parameter {decl!r}")


def _prototypes() -> dict:
    protos = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in PROTO.findall(src.read_text()):
            assert name not in protos, f"{name} defined twice"
            protos[name] = [_kind(p) for p in params.split(",")]
    return protos


def test_every_prototype_has_a_signature():
    assert sorted(_prototypes()) == sorted(_build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_signature_matches_prototype(name):
    proto = _prototypes()[name]
    sig = _build.SIGNATURES[name]
    assert len(sig) == len(proto), f"{name}: arity {len(sig)} != {len(proto)}"
    for i, (s, p) in enumerate(zip(sig, proto)):
        assert s is p, f"{name} argument {i}: ctypes {s.__name__} for C {p.__name__}"


@pytest.mark.parametrize("param,kind", [
    ("const void* q", ctypes.c_void_p), ("void *stream", ctypes.c_void_p),
    ("int b", ctypes.c_int), ("long long q_sb", ctypes.c_longlong),
    ("float scale", ctypes.c_float), ("\n    int smax", ctypes.c_int),
])
def test_param_kinds(param, kind):
    assert _kind(param) is kind


def test_headers_take_part_in_the_build_hash(tmp_path, monkeypatch):
    """An edit of a shared .cuh header must rebuild the library."""
    for src in _build.CSRC.glob("*.cu*"):
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.build_dir()
    header = tmp_path / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.build_dir() != before


def test_build_log_is_kept_beside_the_library(tmp_path, monkeypatch):
    """ptxas's report of a source is read from the build of the current
    sources, and missing when that build has not run."""
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path)
    assert "-v" in _build.COMPILE_FLAGS
    with pytest.raises(FileNotFoundError):
        _build.build_log("flash_full_fwd.cu")
    _build.build_dir().mkdir(parents=True)
    (_build.build_dir() / "flash_full_fwd.log").write_text("ptxas info")
    assert _build.build_log("flash_full_fwd.cu") == "ptxas info"


@pytest.mark.parametrize("ptr,strides,itemsize,ok", [
    (0, (3 * 1024, 1), 2, True),          # a column slice of a fused qkv
    (4096 + 2048, (1024, 1), 2, True),    # slice at column 1024 (bf16)
    (8, (64, 1), 2, False),               # base 8-byte aligned
    (0, (100, 1), 2, False),              # 200-byte rows
    (0, (4098 * 96, 96, 1), 2, True),     # [b, L, h*dh] with h*dh = 96
    (0, (4098 * 4, 4, 1), 4, True),       # f32 rows of 16 bytes
    (0, (4098 * 3, 3, 1), 4, False),      # f32 rows of 12 bytes
])
def test_tma_compatible(ptr, strides, itemsize, ok):
    assert attention.tma_compatible(ptr, strides, itemsize) is ok


@pytest.mark.parametrize("lp,pitch", [(1, 4), (4, 4), (4098, 4100),
                                      (4608, 4608), (7, 8)])
def test_stats_pitch(lp, pitch):
    assert attention.stats_pitch(lp) == pitch
    assert attention.tma_compatible(0, (pitch, 1), 4)


def test_stats_pitch_matches_the_kernel():
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    assert "inline int stats_pitch(int lp) { return (lp + 3) / 4 * 4; }" in src


def test_stats_by_head_layout():
    x = torch.arange(2 * 5 * 3, dtype=torch.float32).reshape(2, 5, 3)
    y = attention._stats_by_head(x)
    assert y.shape == (2, 3, attention.stats_pitch(5))
    torch.testing.assert_close(y[..., :5], x.transpose(1, 2), rtol=0, atol=0)
    assert (y[..., 5:] == 0).all()


@pytest.mark.parametrize("name", ["flash_attn_fwd.cu", "flash_attn_bwd.cu",
                                  "flash_full_fwd.cu", "flash_full_bwd.cu"])
def test_packed_attention_sources_are_wgmma_tma(name):
    """The attention kernels (packed and general route) issue wgmma fed by
    TMA through mbarriers (the PTX lives in hopper.cuh); no mma.sync path is
    left, and no backward adds a float with an atomic (its outputs are
    bit-identical across launches).  The packed backward takes no atomics
    at all; the general route's one-pass backward orders its dQ sums with
    integer atomics only: one u32 fetch-and-add (the CTAs' ticket) beside
    acquire / release counters, and no atomic intrinsic, `red.` or bulk
    reduction."""
    src = (_build.CSRC / name).read_text()
    header = (_build.CSRC / "hopper.cuh").read_text()
    assert '#include "hopper.cuh"' in src
    for used in ("Wgmma<", "tma_load_", "mbar_wait", "setmaxnreg"):
        assert used in src, used
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier."):
        assert ptx in header, ptx
    assert not re.search(r"\bmma\.sync\.aligned", src + header)
    if name == "flash_attn_bwd.cu":
        assert "atomic" not in src.lower()
    if name == "flash_full_bwd.cu":
        assert not re.search(FLOAT_ATOMIC_ADD, src)
        assert re.findall(r"\batom\.[\w.:]+", src) == [
            "atom.relaxed.gpu.global.add.u32"]
        assert "ld.acquire.gpu" in src and "st.release.gpu" in src


# Any way CUDA source can add floats atomically: the atomic intrinsics
# (overloaded, so none at all), PTX red / atom on a float type, and TMA's
# bulk reductions.
FLOAT_ATOMIC_ADD = (r"\batomic[A-Z]\w*\s*\(|\bred\.[\w.:]*\b|"
                    r"\batom\.[\w.:]*\.(?:f16|bf16|f32|f64|f16x2|bf16x2)\b|"
                    r"cp\.reduce\.async\.bulk")


@pytest.mark.parametrize("text,hit", [
    ("atomicAdd(p, 1.f)", True), ("atomicAdd_block (p, x)", True),
    ("red.global.add.f32 [%0], %1;", True),
    ("red.release.gpu.global.add.u32 [%0], 1;", True),
    ("atom.global.add.f32 %0, [%1], %2;", True),
    ("atom.add.noftz.bf16x2 %0, [%1], %2;", True),
    ("cp.reduce.async.bulk.global.shared::cta.add.f32", True),
    ("atom.relaxed.gpu.global.add.u32 %0, [%1], 1;", False),
    ("ld.acquire.gpu.global.u32 %0, [%1];", False),
    ("// no float is added by an atomic", False),
])
def test_float_atomic_add_pattern(text, hit):
    assert bool(re.search(FLOAT_ATOMIC_ADD, text)) is hit


def _fused_views(b, l, h, d):
    """q, k, v [b, l, h, d]: column slices of one fused bf16 qkv, viewed
    per head as the DiT's general route hands them to the kernel."""
    qkv = torch.zeros((b, l, 3 * h * d), dtype=torch.bfloat16)
    return tuple(x.reshape(b, l, h, d) for x in qkv.chunk(3, dim=-1))


def _takes(x) -> bool:
    return attention.full_takes_view(x.data_ptr(), x.shape, x.stride(),
                                     x.element_size())


@pytest.mark.parametrize("b,l,h,d,direct", [
    (1, 4098, 16, 64, True),     # the flagship width, fused qkv slices
    (1, 4098, 16, 48, True),     # 96-byte heads in a 64-wide tile
    (2, 700, 3, 40, True),       # 80-byte heads
    (1, 1100, 5, 20, False),     # 40-byte heads: rows not 16-byte aligned
    (2, 33, 3, 7, False),        # odd d
    (1, 64, 2, 16, True),
])
def test_full_layout_rule_on_fused_slices(b, l, h, d, direct):
    """Which [b, l, h, d] views the general-route kernel reads through TMA
    as they lie, and which take the wrapper's padded copy: a rule on shapes
    and strides alone, the same for q, k and v."""
    for x in _fused_views(b, l, h, d):
        assert _takes(x) is direct


def test_full_layout_rule_subset_halves_and_bench_layout():
    q, k, v = _fused_views(1, 4098, 16, 64)
    assert _takes(q[:, :1026]) and _takes(k[:, :1026])     # first half
    assert _takes(q[:, 1026:]) and _takes(k)                # second half
    q20 = _fused_views(1, 300, 5, 20)[0]
    assert not _takes(q20[:, 100:])
    # mha_full's [h, L, 64] as h batch elements of one head
    x = torch.zeros((16, 4098, 64), dtype=torch.bfloat16)
    assert _takes(x.unsqueeze(2))
    assert not _takes(x[..., 4:].unsqueeze(2))              # d = 60: 120 B
    assert not _takes(x.transpose(1, 2).unsqueeze(2))       # last dim strided


@pytest.mark.parametrize("ptr,shape,strides,ok", [
    (0, (1, 10, 4, 64), (7680, 768, 64, 1), True),
    (8, (1, 10, 4, 64), (7680, 768, 64, 1), False),     # base 8-byte aligned
    (0, (2, 10, 4, 64), (7684, 768, 64, 1), False),     # batch stride
    (0, (1, 10, 4, 64), (7684, 768, 64, 1), True),      # ... of one element
    (0, (1, 1, 4, 64), (1, 1, 64, 1), True),            # one row
    (0, (1, 10, 1, 64), (640, 64, 3, 1), True),         # one head
    (0, (1, 10, 4, 64), (7680, 768, 68, 1), False),     # head stride 136 B
])
def test_full_takes_view_strides(ptr, shape, strides, ok):
    """Strides of dimensions of extent 1 are never used (the kernel's map
    replaces them), every other one must be a multiple of 16 bytes."""
    assert attention.full_takes_view(ptr, shape, strides, 2) is ok


@pytest.mark.parametrize("d,width", [(64, 64), (48, 64), (40, 64), (33, 64),
                                     (32, 32), (20, 32), (17, 32), (16, 16),
                                     (7, 16), (1, 16)])
def test_full_operands_pad_to_the_tile(d, width):
    """Views the kernel takes pass through untouched (the maps read d
    columns); otherwise every operand becomes a contiguous copy zero past d,
    `width` columns wide, which the kernel always takes."""
    assert attention.full_tile_width(d) == width
    g = torch.Generator().manual_seed(d)
    qkv = torch.randn((2, 9, 3 * 3 * d), generator=g).to(torch.bfloat16)
    xs = tuple(x.reshape(2, 9, 3, d) for x in qkv.chunk(3, dim=-1))
    ops, dm = attention._full_operands(*xs)
    if all(_takes(x) for x in xs):
        assert dm == d and all(o is x for o, x in zip(ops, xs))
        return
    assert dm == width
    for o, x in zip(ops, xs):
        assert o.shape == (2, 9, 3, width) and o.is_contiguous() and _takes(o)
        assert torch.equal(o[..., :d], x) and not o[..., d:].any()


def test_full_operands_pad_all_three_together():
    """One refused view pads all three, so the maps share one width."""
    q, _, v = _fused_views(1, 16, 2, 64)
    raw = torch.zeros(16 * 2 * 64 + 4, dtype=torch.bfloat16)
    k = raw[4:].view(1, 16, 2, 64)                  # base 8-byte aligned
    assert _takes(q) and _takes(v) and not _takes(k)
    ops, dm = attention._full_operands(q, k, v)
    assert dm == 64 and all(o.shape == q.shape and o.is_contiguous()
                            and o.data_ptr() != x.data_ptr()
                            for o, x in zip(ops, (q, k, v)))


def test_split_p_carries_p_to_2_pow_minus_16():
    """flash_full_fwd.cu's f32 P·V: P_hi = P with its low 16 bits cleared,
    P_lo = bf16_rn(P - P_hi); P_hi + P_lo is within 2^-16 P of P, over P
    from 2^-100 to 1 (a row's largest P is 1; below 2^-100 the f32
    subnormals of P - P_hi add an absolute error of at most 2^-133)."""
    g = torch.Generator().manual_seed(0)
    p = torch.exp2(-100 * torch.rand(1_000_000, generator=g))
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    lo = (p - hi).to(torch.bfloat16).float()
    assert torch.equal(hi.to(torch.bfloat16).float(), hi)     # bf16-exact
    assert ((p - hi - lo).abs() <= p * 2.0 ** -16).all()
    assert ((p - hi).abs() < p * 2.0 ** -7).all()


def test_split_p_carries_p_to_2_pow_minus_16_up_to_2_pow_tau():
    """#5s takes P against a stale running max (flash_full_stats_kernel,
    RESCALE_TAU), so its P reaches 2^TAU; the split is scale-free (P_lo is
    rounded relative to P - P_hi), so P_hi + P_lo stays within 2^-16 P over
    P from 2^-100 to 2^TAU."""
    g = torch.Generator().manual_seed(1)
    tau = attention.FULL_FWD_RESCALE_TAU
    p = torch.exp2(tau - (100 + tau) * torch.rand(1_000_000, generator=g))
    p[:2] = torch.tensor([2.0 ** tau, 2.0 ** tau * (1 - 2.0 ** -24)])
    hi = (p.view(torch.int32) & -65536).view(torch.float32)
    lo = (p - hi).to(torch.bfloat16).float()
    assert torch.equal(hi.to(torch.bfloat16).float(), hi)
    assert ((p - hi - lo).abs() <= p * 2.0 ** -16).all()


def _stale_max_attention(s, v, tau, keys=128):
    """#5s's online softmax in f32, as flash_full_stats_kernel runs it on f32
    scores s [rows, lk] (natural base) over key tiles of `keys`: a row's
    max moves only when a tile raises it by more than tau in base 2, P =
    2^(s log2 e - m log2 e) split into P_hi + P_lo for P.V, l sums the
    unrounded P.  Returns o, lse (base 2) and the largest P taken."""
    import numpy as np
    log2e = np.float32(attention.LOG2E)
    rows, lk = s.shape
    m = np.full(rows, -np.inf, np.float32)
    l = np.zeros(rows, np.float32)
    o = np.zeros((rows, v.shape[1]), np.float32)
    p_max = 0.0
    for k0 in range(0, lk, keys):
        st = s[:, k0:k0 + keys]
        mt = np.maximum(m, st.max(1))
        up = (mt - m) * log2e > np.float32(tau)
        alpha = np.where(up, np.exp2((m - mt) * log2e), np.float32(1))
        m = np.where(up, mt, m).astype(np.float32)
        p = np.exp2(st * log2e - (m * log2e)[:, None]).astype(np.float32)
        p_max = max(p_max, float(p.max()))
        hi = (p.view(np.int32) & np.int32(-65536)).view(np.float32)
        lo = torch.from_numpy(p - hi).to(torch.bfloat16).float().numpy()
        l = l * alpha + p.sum(1, dtype=np.float32)
        o = o * alpha[:, None] + (hi @ v[k0:k0 + keys] + lo @ v[k0:k0 + keys])
    return o / l[:, None], m * log2e + np.log2(l), p_max


@pytest.mark.parametrize("trend", [0.0, 0.004, -0.004])
def test_stale_max_is_the_same_function(trend):
    """The stale max changes only roundings: o and lse within f32 rounding
    of the exact (f64) softmax at tau = 8 as at tau = 0 (the max moved at
    every rise), P never above 2^tau, and with scores that rise slowly
    along the keys the max stays stale (P > 1 is taken)."""
    import numpy as np
    rng = np.random.default_rng(19)
    rows, lk, d = 64, 1100, 16
    s = (rng.standard_normal((rows, lk)) * 3
         + trend * np.arange(lk)).astype(np.float32)
    v = rng.standard_normal((lk, d)).astype(np.float32)
    s64 = s.astype(np.float64) * attention.LOG2E
    w = np.exp2(s64 - s64.max(1, keepdims=True))
    o_ref = (w @ v.astype(np.float64)) / w.sum(1, keepdims=True)
    lse_ref = s64.max(1) + np.log2(w.sum(1))
    for tau in (0.0, attention.FULL_FWD_RESCALE_TAU):
        o, lse, p_max = _stale_max_attention(s, v, tau)
        assert np.abs(o - o_ref).max() <= 2e-5 * np.abs(o_ref).max()
        assert np.abs(lse - lse_ref).max() <= 2e-5
        assert p_max <= 2.0 ** tau
        if trend > 0 and tau > 0:
            assert p_max > 1.0


@pytest.mark.parametrize("dh", attention.PACKED_DH)
def test_prescaled_q_rounds_once_from_f32(dh):
    """q~ (the forward's and the backward's) is bf16(f32(q) * f32(scale))
    bit for bit, over bf16 values from 1e-30 to 1e30."""
    g = torch.Generator().manual_seed(dh)
    q = (torch.randn(200_000, generator=g)
         * torch.logspace(-30, 30, 200_000)).to(torch.bfloat16)
    want = (q.float() * (dh ** -0.5 * attention.LOG2E)).to(torch.bfloat16)
    assert torch.equal(attention._prescaled_q(q, dh).view(torch.int16),
                       want.view(torch.int16))


@pytest.mark.parametrize("b,lp,l_real,h,dh", [
    (2, 5, 5, 3, 16), (2, 70, 61, 2, 32), (1, 130, 70, 4, 64)])
def test_delta_by_head_matches_masked_cotangent(b, lp, l_real, h, dh):
    """The backward's delta, reduced straight into [b, h, pitch] from the
    unmasked dO, equals the twin's masked delta on the rows < l_real bit for
    bit, is 0 beyond them whatever the pad rows hold, and leaves dO as it
    was."""
    g = torch.Generator().manual_seed(lp)
    do = torch.randn((b, lp, h * dh), generator=g).to(torch.bfloat16)
    o = torch.randn((b, lp, h * dh), generator=g).to(torch.bfloat16)
    do[:, l_real:], o[:, l_real:] = 1e4, float("nan")
    before = do.clone()
    got = attention._delta_by_head(do, o, h, l_real)
    _, want = attention._masked_cotangent(do, o, h, l_real)
    assert got.shape == (b, h, attention.stats_pitch(lp))
    assert torch.equal(got[..., :l_real], want.transpose(1, 2)[..., :l_real])
    assert (got[..., l_real:] == 0).all()
    assert torch.equal(do, before)


@pytest.mark.parametrize("name", ["blend_fwd.cu", "blend_bwd.cu"])
def test_blend_sources_are_the_warp_ring_design(name):
    """Both blends: warps walk independently (no block barrier in the walk:
    the forward has none, the backward one, before its loops), stage rows
    through a cp.async ring (the PTX lives in blend.cuh) and cull whole
    candidates per warp rectangle.  The backward reduces over lanes with
    one reduce-scatter (a single shuffle site, not ten butterflies) and
    takes no atomics (dg is bit-identical across launches)."""
    src = (_build.CSRC / name).read_text()
    header = (_build.CSRC / "blend.cuh").read_text()
    assert '#include "blend.cuh"' in src
    for used in ("stage_rows(", "cp_async_wait<", "misses_rect(",
                 "__ballot_sync", "rect_pixel("):
        assert used in src, used
    for ptx in ("cp.async.ca.shared.global", "cp.async.commit_group",
                "cp.async.wait_group"):
        assert ptx in header, ptx
    barriers = src.count("__syncthreads")
    if name == "blend_fwd.cu":
        assert barriers == 0
    else:
        assert barriers == 1
        assert "atomic" not in src.lower()
        assert src.count("__shfl_xor_sync") == 1
        assert "reduce_scatter(" in src
        assert "mbar_wait(" in src and "mbar_arrive(" in src


def test_blend_constants_match_the_kernels():
    from open_diffusiongs_tpu_torch.ops import blend_kernel
    header = (_build.CSRC / "blend.cuh").read_text()
    assert (f"RECT_W = {blend_kernel.RECT_W}, RECT_H = "
            f"{blend_kernel.RECT_H};") in header
    assert "CULL_RHO = 32.0f * FLT_EPSILON" in header
    assert blend_kernel.CULL_RHO == 32 * torch.finfo(torch.float32).eps
