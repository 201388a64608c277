"""Port parity at the ViL-YOLO widths above scale n, and re-initialization.

* ``TaskModel.init_weights(seed)`` after a train step restores every
  parameter and buffer (BatchNorm statistics, norm affines, the ViL layer's
  learnable skip included) exactly as a fresh ``TaskModel(seed=seed)`` has
  them: the generator draws the same numbers, the rest are constants.
* ``ViLLayer`` at the widest ViL stage of scale x (DIM 320 at P3 of the
  YAML's x row; INNER 640, 10 heads of 64) on an 8x8 token grid, in both
  directions, against the JAX layer on the same weights: the forward and
  the input and weight gradients (the port's hand-written backward on its
  plain forward, frozen stabilizer, against JAX autodiff; gate kernels
  stay at zero so the two conventions agree). Tolerance 1e-4 (rtol and
  atol, as ``test_torch_vil_layer.py``): fp32, summation order only.
* The parameter counts of ``vil_yolo{s,m,l,x}`` against the JAX models'
  (``jax.eval_shape`` of ``init``: shapes only, no forward).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xlstm_yolo_tpu.nn import vil as JV
from xlstm_yolo_tpu.nn.tasks import TaskModel as JaxTaskModel
from xlstm_yolo_torch.engine.trainer import TrainStep
from xlstm_yolo_torch.nn import vil as TV
from xlstm_yolo_torch.nn.tasks import TaskModel
from xlstm_yolo_torch.utils.jax_weights import flatten_variables, load_jax_variables, port_named

TOL = dict(rtol=1e-4, atol=1e-4)


def test_init_weights_after_a_train_step_restores_a_fresh_model():
    model = TaskModel("vil_yolon.yaml", device="cpu", seed=0)
    step = TrainStep(model)
    cb = torch.zeros(2, 8, 5)
    cb[:, 0] = torch.tensor([1.0, 10, 10, 40, 50])
    mask = torch.zeros(2, 8, dtype=torch.bool)
    mask[:, 0] = True
    img = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                                             dtype=np.uint8))
    step({"img": img, "cls_boxes": cb, "mask": mask})
    model.init_weights(0)
    fresh = TaskModel("vil_yolon.yaml", device="cpu", seed=0)
    got, want = model.state_dict(), fresh.state_dict()
    assert got.keys() == want.keys()
    changed = [n for n in want if not torch.equal(got[n], want[n])]
    assert changed == []


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_vil_layer_at_scale_x_width_matches_jax(direction):
    rng = np.random.default_rng(11)
    dim, grid = 320, (8, 8)
    x = rng.normal(size=(2, grid[0] * grid[1], dim)).astype(np.float32)
    kw = dict(dim=dim, direction=direction, qkv_block_size=64, seqlens=grid, chunk_size=32)
    jm = JV.ViLLayer(**kw)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))

    def noise(path, p):  # every parameter matters, but the gate kernels stay at zero
        key = jax.tree_util.keystr(path)
        if ("igate" in key or "fgate" in key) and key.endswith("['kernel']"):
            return p
        return p + 0.05 * jnp.asarray(rng.normal(size=p.shape), p.dtype)

    v = jax.tree_util.tree_map_with_path(noise, v)
    tm = load_jax_variables(TV.ViLLayer(**kw), flatten_variables(v)).eval()
    assert (tm.num_heads, tm.inner) == (10, 640)
    gout = rng.normal(size=x.shape).astype(np.float32)

    def jloss(params, xj):
        return jnp.sum(jm.apply({**v, "params": params}, xj) * gout)

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(v["params"], jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    (out * torch.from_numpy(gout)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x))), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), **TOL)
    want = port_named(flatten_variables(gp))
    named = dict(tm.named_parameters())
    assert want.keys() == named.keys()
    for name, g in want.items():
        got = named[name].grad.numpy()
        if "gate" in name:  # frozen stabilizer: the normalizer-floor terms are dropped
            assert np.abs(got - g).max() <= 2e-2 * np.abs(g).max(), name
        else:
            np.testing.assert_allclose(got, g, err_msg=name, **TOL)


@pytest.mark.parametrize("scale", ["s", "m", "l", "x"])
def test_param_count_matches_jax_above_scale_n(scale):
    cfg = f"vil_yolo{scale}.yaml"
    jm = JaxTaskModel(cfg)
    shapes = jax.eval_shape(lambda: jm.init(0, imgsz=64))
    assert TaskModel(cfg, device="cpu").num_params() == jm.num_params(shapes)
