"""The port's CUDA launch functions against their ctypes signatures, and the
host-side rules of the packed attention wrappers (CPU only).

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


@pytest.mark.parametrize("name", ["flash_attn_fwd.cu", "flash_attn_bwd.cu"])
def test_packed_attention_sources_are_wgmma_tma(name):
    """The packed kernels issue wgmma fed by TMA through mbarriers (the PTX
    lives in hopper.cuh); no mma.sync path is left, and the backward takes
    no atomics (its outputs are bit-identical across launches)."""
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
