"""The port's GPipe pipeline parallelism (parallel/pipeline.py,
models/transformer.py under a `pipe` mesh) and serving over data ranks
(pipeline.py::DiffusionGSPipeline.batch(mesh=)) in gloo processes on the
CPU, against the JAX package and the port on one process.

One world of 2 processes (tests/torch_dist.py::pipeline_parallel_cases),
the packed kernels' plain twins:
  * `pipeline_apply` on JAX's toy stage (tanh(h @ W + c), 4 layers, 2
    stages, 1 and 2 microbatches) against the sequential layers in JAX:
    output atol 1e-6 / rtol 1e-5, the gradients of sum(out^2) for W, x and
    c atol 1e-5 / rtol 1e-4 (tests/test_pipeline.py:40-101);
  * a DiTStack (4 layers of width 256, 2 a stage, 2 microbatches, block
    checkpointing) against JAX's DiTStack with the same weights: output,
    the input's and every parameter's gradient atol 2e-5 / rtol 1e-3
    (tests/test_pipeline.py:104-136);
  * the train step at pp = 2 against one process (loss rtol 1e-4, params
    atol 1e-4), the t-embedder's and the heads' gradients each equal to
    one process's (counted once, not once a stage);
  * a one-process checkpoint restores under pp = 2 bit for bit;
  * `batch(mesh=)` of two images over dp = 2 against the unsharded batch,
    per element: renders and Gaussian centres atol 2e-5
    (tests/test_system_train.py:280-301).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from open_diffusiongs_tpu.models import transformer as jtr
from open_diffusiongs_tpu_torch.pipeline import DiffusionGSPipeline
from test_torch_parallel import OPT, SYSTEM, _equal
from test_torch_ring import _stack_sd
from test_torch_train import _batch
from torch_dist import build_tiny_system, pipeline_parallel_cases, \
    run_world, train_steps

TOL = dict(atol=2e-5, rtol=1e-3)
# 2 layers, one a stage; 2 heads of 64 (the packed route)
PP_SYSTEM = dict(SYSTEM, shape_model={"width": 128, "num_layers": 2,
                                      "patch_size": 8, "dim_heads": 64})
SERVE_SYSTEM = dict(SYSTEM, num_inference_steps=2)
SERVE_KW = dict(resolution=16, n_views=2, seed=3)


def _toy_refs(rng):
    layers, d, b = 4, 8, 4
    params = rng.normal(0, 0.5, (layers, d, d)).astype(np.float32)
    x = rng.normal(size=(b, 3, d)).astype(np.float32)
    c = rng.normal(size=(b, 1, d)).astype(np.float32)

    def ref(p, x_, c_):
        h = x_
        for i in range(layers):
            h = jnp.tanh(h @ p[i] + c_)
        return h
    args = tuple(jnp.asarray(a) for a in (params, x, c))
    grads = jax.grad(lambda *a: jnp.sum(ref(*a) ** 2),
                     argnums=(0, 1, 2))(*args)
    return (params, x, c), (np.asarray(ref(*args)),
                            [np.asarray(g) for g in grads])


def _stack_refs(rng):
    b, l, width, heads, layers = 2, 70, 256, 4, 4
    x = rng.normal(size=(b, l, width)).astype(np.float32)
    c = rng.normal(size=(b, width)).astype(np.float32)
    r = rng.normal(size=(b, l, width)).astype(np.float32)
    jx, jc, jr = (jnp.asarray(a) for a in (x, c, r))
    mod = jtr.DiTStack(hidden_size=width, num_heads=heads,
                       num_layers=layers, remat=True, attn_impl="xla")
    params = mod.init(jax.random.PRNGKey(0), jx, jc)

    def loss(p, x_):
        return jnp.sum(mod.apply(p, x_, jc) * jr)
    y, (gp, gx) = jax.jit(lambda p, x_: (
        mod.apply(p, x_, jc), jax.grad(loss, argnums=(0, 1))(p, x_)))(
            params, jx)
    case = dict(x=x, c=c, r=r, width=width, heads=heads, layers=layers,
                sd=_stack_sd(params))
    return case, (np.asarray(y), np.asarray(gx), _stack_sd(gp))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline_parallel")
    rng = np.random.default_rng(0)
    inputs, refs = {}, {}
    inputs["toy"], refs["toy"] = _toy_refs(rng)
    inputs["stack"], refs["stack"] = _stack_refs(rng)
    case = dict(system=PP_SYSTEM, opt=OPT,
                batch=_batch(rng, b=2, res=16, v=2))
    refs["one"] = train_steps(case, None, 1, slice(0, 2),
                              save=str(tmp / "one"))
    images = [rng.uniform(size=(3, 16, 16)).astype(np.float32)
              for _ in range(2)]
    serve = dict(system=SERVE_SYSTEM, images=images, kw=SERVE_KW)
    refs["serve"] = DiffusionGSPipeline(build_tiny_system(serve)).batch(
        images, **SERVE_KW)
    inputs.update(case=case, one_dir=str(tmp / "one"), serve=serve)
    outs = run_world(pipeline_parallel_cases, 2, tmp / "world", inputs)
    return dict(inputs=inputs, refs=refs, outs=outs)


@pytest.mark.parametrize("mb", [1, 2])
def test_pipeline_apply_matches_sequential(world, mb):
    want_y, (gw, gx, gc) = world["refs"]["toy"]
    per = gw.shape[0] // 2
    for p, o in enumerate(world["outs"]):
        y, w_grad, x_grad, c_grad = (t.numpy() for t in o["toy"][mb])
        np.testing.assert_allclose(y, want_y, atol=1e-6, rtol=1e-5)
        grad_tol = dict(atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(w_grad, gw[p * per:(p + 1) * per],
                                   **grad_tol)
        np.testing.assert_allclose(x_grad, gx, **grad_tol)
        np.testing.assert_allclose(c_grad, gc, **grad_tol)


def test_pipeline_dit_stack_matches_jax(world):
    want_y, want_gx, want_gp = world["refs"]["stack"]
    for o in world["outs"]:
        st = o["stack"]
        assert len(st["packed"]) == 2 and all(st["packed"])
        np.testing.assert_allclose(st["y"].numpy(), want_y, **TOL)
        np.testing.assert_allclose(st["gx"].numpy(), want_gx, **TOL)
        assert set(st["grads"]) == set(want_gp)
        for name, want in want_gp.items():
            np.testing.assert_allclose(st["grads"][name].numpy(),
                                       want.numpy(), err_msg=name, **TOL)


def test_pipeline_train_step_matches_one_process(world):
    one = world["refs"]["one"]
    for o in world["outs"]:
        tr = o["train"]
        np.testing.assert_allclose(tr["metrics"][0]["loss"],
                                   one["metrics"][0]["loss"], rtol=1e-4)
        np.testing.assert_allclose(tr["metrics"][0]["grad_norm"],
                                   one["metrics"][0]["grad_norm"],
                                   rtol=1e-4)
        assert set(tr["params"]) == set(one["params"])
        for k, want in one["params"].items():
            np.testing.assert_allclose(tr["params"][k].numpy(), want.numpy(),
                                       atol=1e-4, rtol=0, err_msg=k)
        # replicated over `pipe`: the gradient is counted once
        for k, want in one["grads"].items():
            if k.startswith(("t_embedder.", "upsampler.",
                             "image_token_decoder.")):
                scale = float(want.abs().max())
                np.testing.assert_allclose(
                    tr["grads"][k].numpy(), want.numpy(), rtol=1e-4,
                    atol=1e-6 * scale, err_msg=k)


def test_one_process_checkpoint_restores_under_pp(world):
    one = world["refs"]["one"]
    for o in world["outs"]:
        r = o["resume"]
        assert r["count"] == 1
        for key in ("params", "ema", "mu", "nu"):
            _equal(r[key], one[key])


def test_batch_over_data_ranks_matches_unsharded(world):
    """Every rank returns both elements in input order, each equal to the
    unsharded batch's."""
    want = world["refs"]["serve"]
    for o in world["outs"]:
        assert len(o["serve"]) == len(want) == 2
        for (renders, xyz), w in zip(o["serve"], want):
            np.testing.assert_allclose(renders, w.renders, atol=2e-5,
                                       rtol=0)
            np.testing.assert_allclose(xyz, w.gaussians.xyz, atol=2e-5,
                                       rtol=0)


def test_batch_refuses_a_bundle_that_does_not_divide():
    from open_diffusiongs_tpu_torch.parallel.mesh import Mesh
    pipe = DiffusionGSPipeline(build_tiny_system(dict(system=SERVE_SYSTEM)))
    with pytest.raises(ValueError, match="must divide the data ranks"):
        pipe.batch([np.zeros((3, 16, 16), np.float32)] * 3,
                   mesh=Mesh(world=2, rank=0), **SERVE_KW)
