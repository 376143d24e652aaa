"""The port's tensor parallelism (parallel/{mesh,shard,tensor_parallel}.py,
models/transformer.py under a `model` mesh) in gloo processes on the CPU,
against the JAX package and against the port on one rank.

One world of 4 processes (tests/torch_dist.py::tensor_parallel_cases), the
packed kernels' plain twins:
  * a DiTStack (2 layers, 4 heads of 64: 2 local heads, the packed route;
    and 2 heads of 64: 1 local head, the general route; under block
    checkpointing) and a qk_norm DiTBlock (4 heads of 32) at dp = 2 x
    tp = 2 against JAX's unsharded
    DiTStack with the same (bridged) weights: output and the input's
    gradient atol 2e-5 / rtol 1e-3, every parameter's gradient (the model
    ranks' shards put together, summed over the data rows) atol 2e-5 /
    rtol 1e-3 (tests/test_attention.py:170-200, test_pipeline.py:104-136);
  * ring attention at sp = 2 x tp = 2 on the local heads against exact
    attention in JAX (tests/test_ring.py:107-120): forward atol 2e-5 /
    rtol 1e-4, gradients atol 3e-5 / rtol 1e-3;
  * the W8A8 stack at dp = 2 x tp = 2 (the exact 'xla' attention on both
    sides) against the port's one-rank W8A8 stack bit for bit in f32, and
    against JAX's quant stack: 99.9 % of the elements within atol 2e-4 /
    rtol 1e-3 (tests/test_quant.py:120-155), cosine >= 0.9999 and mean
    relative error <= 1e-3 (tests/test_torch_quant.py's bars: an int8
    rounding can flip between two f32 summation orders);
  * a train step (dp = 2 x tp = 2) against one process (loss rtol 1e-4,
    params atol 1e-4: tests/test_system_train.py:145-175, the params where
    the gradient is not within 100 x Adam's eps; every gradient within
    1e-4 of its tensor's largest);
  * ZeRO-1 x TP equals DDP x TP bit for bit (params, EMA, Adam moments,
    grad_norm, loss);
  * checkpoints across layouts: a one-process checkpoint restores under
    tp = 2, a tp = 2 checkpoint on one process, bit for bit.
Also the qkv shard and its inverse against JAX's q / k / v shards, the
sharding rule against JAX's dit_tp_rule, and the layout's checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from open_diffusiongs_tpu.models import transformer as jtr
from open_diffusiongs_tpu.parallel.mesh import dit_tp_rule
from open_diffusiongs_tpu_torch.parallel import mesh as tmesh
from open_diffusiongs_tpu_torch.parallel import shard
from open_diffusiongs_tpu_torch.utils.checkpoint import CheckpointManager
from open_diffusiongs_tpu_torch.utils.convert import (
    block_state_dict_from_flax, flatten_params)
from test_torch_parallel import OPT, _equal, _one_process_state
from test_torch_quant import _cos
from test_torch_ring import _stack_sd
from test_torch_train import _batch
from torch_dist import run_world, tensor_parallel_cases, train_steps

TOL = dict(atol=2e-5, rtol=1e-3)
RING_FWD_TOL = dict(atol=2e-5, rtol=1e-4)
RING_GRAD_TOL = dict(atol=3e-5, rtol=1e-3)
QUANT_TOL = dict(atol=2e-4, rtol=1e-3)
# the share of the W8A8 output within QUANT_TOL of JAX's: the port on one
# rank already differs from JAX where an activation's int8 rounding flips
# between two f32 summation orders (31 of 76,800 elements here, up to
# 1.04e-3), so the TP stack is held bit for bit to the one-rank port and
# to JAX as tests/test_torch_quant.py holds the one-rank port
QUANT_CLOSE_SHARE = 0.999
# the packed route at tp = 2: 4 heads of 64, 2 a model rank
TP_SYSTEM = {
    "use_lpips": False,
    "shape_model": {"width": 256, "num_layers": 2, "patch_size": 8,
                    "dim_heads": 64},
    "raster": {"max_tiles_per_gaussian": 16, "max_per_tile": 1056,
               "blend_chunk": 32},
    "loss": {"lambda_diffusion": 1.0, "lambda_lpips": 0.0,
             "lambda_ssim": 0.0, "lambda_pointsdist": 0.1,
             "lambda_xyz": 0.0},
}


def _stack_refs(rng, quant=False, width=256, heads=4, qk_norm=False):
    """Inputs, port state dict and JAX output / gradients of a 2-layer
    stack (by default width 256, 4 heads of 64), or of one qk_norm block,
    on two samples."""
    b, l = 2, 300
    x = rng.normal(size=(b, l, width)).astype(np.float32)
    c = rng.normal(size=(b, width)).astype(np.float32)
    r = rng.normal(size=(b, l, width)).astype(np.float32)
    jx, jc, jr = (jnp.asarray(a) for a in (x, c, r))
    if qk_norm:
        mod = jtr.DiTBlock(width, heads, qk_norm=True, attn_impl="xla")
        to_sd = lambda p: block_state_dict_from_flax(jax.device_get(p))
    else:
        mod = jtr.DiTStack(hidden_size=width, num_heads=heads, num_layers=2,
                           remat=not quant, attn_impl="xla",
                           quant_int8=quant)
        to_sd = _stack_sd
    params = mod.init(jax.random.PRNGKey(0), jx, jc)
    case = dict(x=x, c=c, r=r, width=width, heads=heads, layers=2,
                qk_norm=qk_norm, sd=to_sd(params))
    if quant:
        return case, np.asarray(jax.jit(mod.apply)(params, jx, jc))

    def loss(p, x_):
        return jnp.sum(mod.apply(p, x_, jc) * jr)
    y, (gp, gx) = jax.jit(lambda p, x_: (
        mod.apply(p, x_, jc), jax.grad(loss, argnums=(0, 1))(p, x_)))(
            params, jx)
    return case, (np.asarray(y), np.asarray(gx), to_sd(gp))


def _ring_refs(rng):
    """q, k, v [2, 256, 4·32] (rows >= 200 padding) and JAX's exact
    attention with the gradients of sum(out[:, :200]^2)."""
    b, lp, h, dh, l_real = 2, 256, 4, 32, 200
    q, k, v = (rng.normal(size=(b, lp, h * dh)).astype(np.float32)
               for _ in range(3))

    def attend(q_, k_, v_):
        four = [a[:, :l_real].reshape(b, l_real, h, dh) for a in (q_, k_, v_)]
        o = jax.nn.dot_product_attention(*four).reshape(b, l_real, h * dh)
        return jnp.pad(o, ((0, 0), (0, lp - l_real), (0, 0)))
    args = tuple(jnp.asarray(a) for a in (q, k, v))
    out = np.asarray(attend(*args))
    grads = jax.grad(lambda *a: jnp.sum(attend(*a)[:, :l_real] ** 2),
                     argnums=(0, 1, 2))(*args)
    return (q, k, v, h, l_real), (out, [np.asarray(g) for g in grads])


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tensor_parallel")
    rng = np.random.default_rng(0)
    inputs, refs = {}, {}
    inputs["stack"], refs["stack"] = _stack_refs(rng)
    # 2 heads of 64: one a model rank, which fails the lane test
    inputs["general"], refs["general"] = _stack_refs(rng, width=128,
                                                     heads=2)
    # the general route with q / k norms on 2 local heads of 32
    inputs["qk_norm"], refs["qk_norm"] = _stack_refs(rng, width=128,
                                                     heads=4, qk_norm=True)
    inputs["quant"], refs["quant"] = _stack_refs(rng, quant=True)
    inputs["ring"], refs["ring"] = _ring_refs(rng)
    case = dict(system=TP_SYSTEM, opt=OPT, batch=_batch(rng, b=2, res=16,
                                                        v=2))
    refs["saved"] = train_steps(case, None, 1, slice(0, 2),
                                save=str(tmp / "one"))
    inputs.update(case=case, save_dir=str(tmp / "tp"),
                  one_dir=str(tmp / "one"))
    outs = run_world(tensor_parallel_cases, 4, tmp / "world", inputs)
    return dict(inputs=inputs, refs=refs, outs=outs, tmp=tmp)


@pytest.mark.parametrize("key,packed", [("stack", True),
                                        ("general", False),
                                        ("qk_norm", False)])
def test_tp_stack_matches_jax(world, key, packed):
    """Ranks (d, m) = (rank // 2, rank % 2) each hold sample d's whole
    output; 2 local heads of 64 take the packed route, 1 the general
    route (JAX's lane test on the local heads), and so does a qk_norm
    block, whose replicated q / k norms see the local heads only."""
    want_y, want_gx, want_gp = world["refs"][key]
    outs = world["outs"]
    for rank, o in enumerate(outs):
        d = rank // 2
        st = o[key]
        assert set(st["packed"]) == {packed}
        np.testing.assert_allclose(st["y"][0].numpy(), want_y[d], **TOL)
        np.testing.assert_allclose(st["gx"][0].numpy(), want_gx[d], **TOL)
    assert set(outs[0][key]["grads"]) == set(want_gp)
    for name, want in want_gp.items():
        got = outs[0][key]["grads"][name] + outs[2][key]["grads"][name]
        np.testing.assert_allclose(got.numpy(), want.numpy(), err_msg=name,
                                   **TOL)
        # the model ranks of a data row agree on the whole gradient
        assert torch.equal(outs[0][key]["grads"][name],
                           outs[1][key]["grads"][name]), name


def test_tp_stack_counts_its_model_sums(world):
    """Per layer: the forward's proj and fc2 sums, the checkpointed
    recompute's two, and the backward's qkv and fc1 input sums, each of a
    [1, 300, 256] f32 tensor."""
    per = 1 * 300 * 256 * 4
    assert all(o["stack_bytes"] == 2 * 6 * per for o in world["outs"])


def test_tp_ring_matches_jax(world):
    """sp = 2 x tp = 2: rank (s, m) = (rank // 2, rank % 2) holds rows s of
    heads m."""
    (q, *_, h, l_real), (want_o, want_g) = (world["inputs"]["ring"],
                                            world["refs"]["ring"])
    lq, w = q.shape[1] // 2, q.shape[-1] // 2
    o = np.zeros_like(want_o)
    g = [np.zeros_like(x) for x in want_g]
    for rank, out in enumerate(world["outs"]):
        s, m = rank // 2, rank % 2
        rows, cols = slice(s * lq, (s + 1) * lq), slice(m * w, (m + 1) * w)
        o_r, g_r = (t.numpy() for t in out["ring"])
        o[:, rows, cols] = o_r
        for i in range(3):
            g[i][:, rows, cols] = g_r[..., i * w:(i + 1) * w]
    np.testing.assert_allclose(o[:, :l_real], want_o[:, :l_real],
                               **RING_FWD_TOL)
    for i, name in enumerate("qkv"):
        np.testing.assert_allclose(g[i], want_g[i], err_msg=f"d{name}",
                                   **RING_GRAD_TOL)


def test_tp_w8a8_stack_matches_jax_and_one_rank(world):
    want = world["refs"]["quant"]
    for rank, o in enumerate(world["outs"]):
        got = o["quant"]
        assert torch.equal(got["tp"], got["one"])
        a = got["tp"][0].numpy().astype(np.float64)
        b = want[rank // 2].astype(np.float64)
        close = np.isclose(a, b, **QUANT_TOL)
        assert close.mean() >= QUANT_CLOSE_SHARE, 1 - close.mean()
        assert _cos(a, b) >= 0.9999
        assert np.abs(a - b).mean() / np.abs(b).mean() <= 1e-3


def test_tp_train_step_matches_one_process(world):
    """One dp = 2 x tp = 2 step (one sample a data row) against one process
    on both samples: the loss (the ranks' mean) rtol 1e-4, grad_norm rtol
    1e-4, every gradient (the model ranks' parts put together, averaged
    over the data rows) within 1e-4 of its tensor's largest, and the params
    atol 1e-4 where the one-process gradient is at least 100 x Adam's eps.
    Below that an update lr·g / (|g| + eps) turns on g's last bits, which
    the dp = 2 split of the batch's sums moves: 2 of the 229,376 elements
    of the replicated image_token_decoder.linear.weight sit 1.4e-4 apart
    after two steps, as they would at dp = 2 alone."""
    one = world["refs"]["saved"]
    outs = world["outs"]
    loss = np.mean([o["step"]["metrics"][0]["loss"] for o in outs])
    np.testing.assert_allclose(loss, one["metrics"][0]["loss"], rtol=1e-4)
    eps = 1e-8                  # OptimizerConfig's default, as OPT's
    for o in outs:
        np.testing.assert_allclose(o["step"]["metrics"][0]["grad_norm"],
                                   one["metrics"][0]["grad_norm"], rtol=1e-4)
        assert set(o["step"]["params"]) == set(one["params"])
    for k, g in one["grads"].items():
        got = (outs[0]["step"]["grads"][k] + outs[2]["step"]["grads"][k]) / 2
        scale = float(g.abs().max())
        assert float((got - g).abs().max()) <= 1e-4 * scale + 1e-12, k
        sure = g.abs() >= 100 * eps
        for o in outs:
            np.testing.assert_allclose(o["step"]["params"][k][sure].numpy(),
                                       one["params"][k][sure].numpy(),
                                       atol=1e-4, rtol=0, err_msg=k)


def test_zero1_tp_equals_ddp_tp_bit_for_bit(world):
    for o in world["outs"]:
        ddp, z = o["ddp"], o["zero1"]
        assert z["zero1"] and not ddp["zero1"]
        for key in ("params", "ema", "mu", "nu"):
            _equal(z[key], ddp[key])
        for key in ("grad_norm", "loss"):
            assert [m[key] for m in z["metrics"]] == \
                [m[key] for m in ddp["metrics"]]


def test_one_process_checkpoint_restores_under_tp(world):
    saved = world["refs"]["saved"]
    for o in world["outs"]:
        r = o["resume"]
        assert r["count"] == 1
        for key in ("params", "ema", "mu", "nu"):
            _equal(r[key], saved[key])


def test_tp_checkpoint_restores_on_one_process(world):
    z = world["outs"][0]["zero1"]
    state = _one_process_state(dict(system=TP_SYSTEM))
    CheckpointManager(str(world["tmp"] / "tp")).restore(state)
    assert state.step == 2 and state.optimizer.count == 2
    _equal(state.params, z["params"])
    _equal(state.ema_params, z["ema"])
    sd = state.optimizer.state_dict()
    _equal(sd["mu"], z["mu"])
    _equal(sd["nu"], z["nu"])


@pytest.mark.parametrize("tp", [2, 4])
def test_qkv_shard_is_jax_qkv_shards(tp):
    """Model rank m's fused-qkv rows are JAX's q, k and v shards of rank m
    (dit_tp_rule splits each kernel's output axis), and the inverse puts
    the ranks' parts back bit for bit."""
    rng = np.random.default_rng(tp)
    d = 64
    kern = {p: rng.normal(size=(d, d)).astype(np.float32) for p in "qkv"}
    bias = {p: rng.normal(size=(d,)).astype(np.float32) for p in "qkv"}
    whole = {"attn.qkv.weight": torch.from_numpy(np.concatenate(
                 [kern[p].T for p in "qkv"])),
             "attn.qkv.bias": torch.from_numpy(np.concatenate(
                 [bias[p] for p in "qkv"]))}
    w = d // tp
    for name, t in whole.items():
        parts = [shard.shard_tensor(name, t, tp, m) for m in range(tp)]
        for m, part in enumerate(parts):
            cols = slice(m * w, (m + 1) * w)
            want = ([kern[p][:, cols].T for p in "qkv"]
                    if name.endswith("weight") else
                    [bias[p][cols] for p in "qkv"])
            assert np.array_equal(part.numpy(), np.concatenate(want)), name
        assert torch.equal(shard.unshard_tensor(name, parts), t)


def test_sharding_rule_is_jax_dit_tp_rule():
    """Every leaf of JAX's block maps to the port's name with the same
    split: JAX's model axis on the output (kernel axis 2, bias axis 1) is
    the torch weight's dim 0, on the input (kernel axis 1) its dim 1."""
    mod = jtr.DiTStack(hidden_size=128, num_heads=2, num_layers=2,
                       attn_impl="xla")
    x, c = jnp.zeros((1, 8, 128)), jnp.zeros((1, 128))
    flat = flatten_params(jax.device_get(mod.init(jax.random.PRNGKey(0),
                                                  x, c)))
    names = {"attn/q": "attn.qkv", "attn/k": "attn.qkv", "attn/v": "attn.qkv",
             "attn/proj": "attn.proj", "mlp/fc1": "mlp.fc1",
             "mlp/fc2": "mlp.fc2", "adaLN_modulation_1": "adaLN_modulation.1"}
    for path, leaf in flat.items():
        spec = tuple(dit_tp_rule(path.split("/"), leaf))
        module = next(v for k, v in names.items() if f"block/{k}/" in path)
        kind = path.rsplit("/", 1)[1]
        port = f"0.{module}.{'weight' if kind == 'kernel' else 'bias'}"
        want = (None if "model" not in spec else
                {2: 0, 1: 1}[spec.index("model")] if kind == "kernel"
                else 0)
        assert shard.tp_dim(port) == want, (path, spec)


def test_layout_and_parallelism_rules():
    """rank = ((d·pp + p)·sp + s)·tp + m; each axis and their product must
    divide the world; pipe composes with data parallelism alone."""
    g = tmesh.axis_groups(8, sp=2, tp=2)
    assert g["model"] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert g["seq"] == [[0, 2], [1, 3], [4, 6], [5, 7]]
    assert g["data"] == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert g["replica"] == [[0, 2, 4, 6], [1, 3, 5, 7]]
    g = tmesh.axis_groups(4, pp=2)
    assert g["pipe"] == [[0, 1], [2, 3]] and g["data"] == [[0, 2], [1, 3]]
    m = tmesh.Mesh(world=8, rank=5, sp=2, tp=2)
    assert (m.dp, m.data_rank, m.seq_rank, m.model_rank, m.replicas) == \
        (2, 1, 0, 1, 4)
    assert tmesh.check_parallelism({"model_parallel": 2, "seq_parallel": 2},
                                   8) == (2, 1, 2, 2)
    assert tmesh.check_parallelism({"pipe_parallel": 2}, 4) == (2, 2, 1, 1)
    with pytest.raises(ValueError, match="composes with dp only"):
        tmesh.check_parallelism({"pipe_parallel": 2, "model_parallel": 2}, 4)
    with pytest.raises(ValueError, match="composes with dp only"):
        tmesh.check_parallelism({"pipe_parallel": 2, "seq_parallel": 2}, 4)
    with pytest.raises(ValueError, match="does not divide the world size 6"):
        tmesh.check_parallelism({"model_parallel": 4}, 6)
    with pytest.raises(ValueError, match="does not divide the world size 2"):
        tmesh.check_parallelism({"model_parallel": 2, "seq_parallel": 2}, 2)
