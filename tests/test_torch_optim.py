"""The port's optimizer against optax, in float32 on the CPU: the OneCycle
schedule (rtol 1e-6: optax evaluates in float32), the decay mask (no
decay on batch-norm parameters and biases) and five AdamW + OneCycle
steps of the optimizer alone on the same gradients, with the decay mask
and with ``finetune_layer`` none, stage2 and all: parameters within rtol
1e-5, atol 1e-7, frozen ones unchanged.  (At step 1 Adam sends any tiny
gradient to +-lr, so parameters after whole train steps would not be a
fair comparison; ``test_torch_train.py`` holds the gradients.)
"""

import jax
import numpy as np
import optax
import pytest
import torch

import empanada_tpu.train as JT
import empanada_tpu_torch.train as T
from _torch_port import jax_init, one_torch_thread, port_model  # noqa: F401
from empanada_tpu.train.loop import _apply_freeze
from empanada_tpu_torch.train.state import decay_mask
from test_torch_train import PLAIN, TRAIN_MODELS, _mask_tree, _tensors


def test_onecycle_schedule_matches_optax():
    for total, pct in ((10, 0.3), (57, 0.25), (1, 0.3)):
        want = JT.onecycle_schedule(3e-3, total, pct)
        got = T.onecycle_schedule(3e-3, total, pct)
        for s in range(total + 3):
            # optax evaluates in float32
            np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6, atol=1e-10)


def test_decay_mask_matches_jax():
    """No decay on batch-norm parameters and biases; kernels and BiFPN's
    fusion weights decayed."""
    from empanada_tpu.train.state import _decay_mask

    for arch, kw, size in TRAIN_MODELS:
        _, variables = jax_init(arch, kw, size=size)
        tmodel = port_model(arch, kw, variables)
        jax_mask = _mask_tree(_decay_mask(variables["params"]), variables["params"])
        want = _tensors(jax_mask, tmodel, variables["batch_stats"])
        got = decay_mask(tmodel)
        assert sorted(got) == sorted(n for n, _ in tmodel.named_parameters())
        for name, flag in got.items():
            assert flag == bool(want[name].reshape(-1)[0]), name
        if arch == "PanopticBiFPNPR":
            assert got["semantic_fpn.bifpn1.top_down.fusion_weights"]


@pytest.mark.parametrize("finetune_layer", ["none", "stage2", "all"])
def test_adamw_onecycle_matches_optax(finetune_layer):
    """Five steps of the optimizer alone on the same gradients: optax's
    adamw with the decay mask (and JAX's freezing) against the port's, on
    the plain model (fewer leaves to compile; the optimizer is per leaf)."""
    model, variables = jax_init("PanopticDeepLab", PLAIN, size=64)
    params = variables["params"]
    total, wd = 20, 0.1
    tx = JT.adamw_with_decay_mask(JT.onecycle_schedule(3e-3, total, 0.3), wd)
    trainable_jax = JT.freeze_encoder_mask(params, finetune_layer)
    if finetune_layer != "none":
        tx = _apply_freeze(tx, trainable_jax)
    opt_state = tx.init(params)
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda p: 1e-2 * rng.standard_normal(p.shape, np.float32), params)
             for _ in range(5)]

    @jax.jit
    def update(params, opt_state, g):
        updates, opt_state = tx.update(g, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    p = params
    for g in grads:
        p, opt_state = update(p, opt_state, g)

    tmodel = port_model("PanopticDeepLab", PLAIN, variables)
    trainable = T.freeze_encoder_mask(tmodel, finetune_layer)
    state = T.create_train_state(tmodel, T.onecycle_schedule(3e-3, total, 0.3), wd,
                                 trainable=None if finetune_layer == "none" else trainable)
    jax_trainable = _tensors(_mask_tree(trainable_jax, params), tmodel,
                             variables["batch_stats"])
    named = dict(tmodel.named_parameters())
    assert {n: bool(jax_trainable[n].reshape(-1)[0]) for n in named} == trainable
    for g in grads:
        gt = _tensors(g, tmodel, variables["batch_stats"])
        for name, prm in named.items():
            prm.grad = gt[name].clone() if prm.requires_grad else None
        lr = state.schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
        state.optimizer.step()
        state.step += 1
    want = _tensors(jax.tree.map(np.asarray, p), tmodel, variables["batch_stats"])
    start = _tensors(params, tmodel, variables["batch_stats"])
    for name, prm in named.items():
        np.testing.assert_allclose(prm.detach().numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        if not trainable[name]:
            assert torch.equal(prm.detach(), start[name]), name
    assert any(not t for t in trainable.values()) == (finetune_layer != "none")


