"""The port's training layer against the JAX package's, in float32 on the
CPU with the same weights (seeded values in the flax tree, carried by the
weight bridge) and the same inputs:

- train-mode batch norm (the batch statistics and the running update);
- the train forward of ``PanopticDeepLabPR``, ``PanopticDeepLabBC`` and
  ``PanopticBiFPNPR`` with JAX's PointRend points fed in: every output
  within 2e-4 of its largest magnitude (batch statistics over 2 images of
  4 x 4 pixels deep in the encoder amplify float32 rounding; measured
  1.5e-5 to 8.5e-5), the points equal, the new batch statistics at rtol
  1e-5 with a floor of 1e-4 of each tensor's largest magnitude (measured
  up to 2.3e-5, BiFPN's);
- ``PanopticLoss`` and ``BCLoss`` on a fixed batch: within 1e-6;
- one float32 step's loss (within 1e-5 relative), gradients, through
  ``from_flax``, at rtol 1e-4 with an absolute floor of 1e-4 of each
  tensor's largest gradient (near-zero entries have no relative scale),
  and new batch statistics at a floor of 1e-5;
- ``fast_matcher``, IoU, PQ and F1 equal.

The optimizer's tests are in ``test_torch_optim.py``, the loop's in
``test_torch_train_loop.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import empanada_tpu.train as JT
import empanada_tpu_torch.train as T
from _torch_port import SMALL_PR, jax_init, one_torch_thread, port_model  # noqa: F401
from empanada_tpu.models.blocks import batch_norm as jax_batch_norm
from empanada_tpu.stitch.matcher import fast_matcher as jax_fast_matcher
from empanada_tpu_torch.models.blocks import BatchNorm
from empanada_tpu_torch.port.weights import flatten_variables, from_flax
from empanada_tpu_torch.stitch.matcher import fast_matcher
from flax import linen as nn

TOL = 1e-5
TRAIN_TOL = 2e-4  # of the largest magnitude of a train-mode output
# the PointRend model of the tests: MitoNet_v1's chain at small widths,
# fc_dim = decoder 32, 64 train points, no ASPP dropout (JAX's and the
# port's draws differ, so parity runs without it)
TRAIN_PR = dict(SMALL_PR, train_num_points=64, aspp_dropout=0.0)
PLAIN = dict(encoder="resnet18", num_classes=1, decoder_channels=16, low_level_stages=[1],
             low_level_channels_project=[8])
SMALL_MINI = dict(encoder="regnety_200mf", num_classes=1, fpn_dim=32, fpn_layers=2,
                  ins_decoder=False, depthwise=True, subdivision_num_points=256,
                  train_num_points=64)


def _batch(n=2, size=64, seed=0, bc=False):
    rng = np.random.default_rng(seed)
    batch = {"image": rng.normal(0, 1, (n, size, size, 1)).astype(np.float32),
             "sem": rng.integers(0, 2, (n, size, size)).astype(np.int32)}
    if bc:
        batch["cnt"] = rng.integers(0, 2, (n, size, size)).astype(np.int32)
    else:
        batch["ctr_hmp"] = rng.random((n, size, size, 1)).astype(np.float32)
        batch["offsets"] = rng.normal(0, 2, (n, size, size, 2)).astype(np.float32)
    return batch


def _tensors(tree, model, batch_stats):
    """A flax tree (params, grads) as the port's tensors by name; the
    bridge wants every leaf, so ``batch_stats`` completes the tree."""
    return from_flax({"params": tree, "batch_stats": batch_stats}, model)


def _mask_tree(mask, params):
    """A boolean flax tree as float arrays of its leaves' shapes (the
    bridge converts whole tensors)."""
    return jax.tree.map(lambda m, p: np.full(p.shape, m, np.float32), mask, params)


def _close(got, want, rtol, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = floor * max(np.abs(want).max(), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# ---- batch norm ------------------------------------------------------------


def test_batch_norm_train_statistics_and_update():
    """Batch statistics (biased variance) normalise the batch; the running
    statistics become 0.9 running + 0.1 batch with the BIASED variance;
    eval mode and a module in ``train()`` still use the running ones."""
    rng = np.random.default_rng(0)
    x = rng.normal(1.5, 2.0, (3, 9, 7, 5)).astype(np.float32)
    mean0 = rng.normal(0, 0.1, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 0.1, 5).astype(np.float32)

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x, train):
            return jax_batch_norm(x, train, jnp.float32)

    variables = {"params": {"bn": {"scale": scale, "bias": bias}},
                 "batch_stats": {"bn": {"mean": mean0, "var": var0}}}
    want, mutated = Net().apply(variables, x, train=True, mutable=["batch_stats"])
    bn = BatchNorm(5)
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean0),
                     (bn.running_var, var0)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bn.eval()  # the mode is the argument, not nn.Module.training
    got = bn(xt, train=True).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=TOL)
    new = mutated["batch_stats"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(new["mean"]), rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(new["var"]), rtol=1e-6)
    biased = x.reshape(-1, 5).astype(np.float64).var(0)
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * var0 + 0.1 * biased, rtol=1e-5)

    want_eval = Net().apply({"params": variables["params"], "batch_stats": {"bn": new}}, x,
                            train=False)
    bn.train()
    np.testing.assert_allclose(bn(xt).permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want_eval), rtol=0, atol=TOL)


def test_engine_output_ignores_module_mode():
    """``model.train()`` does not switch the engines to batch statistics."""
    from empanada_tpu_torch.engine import PanopticDeepLabRenderEngine

    _, variables = jax_init("PanopticDeepLabPR", TRAIN_PR, size=64)
    tmodel = port_model("PanopticDeepLabPR", TRAIN_PR, variables)
    img = np.random.default_rng(1).normal(0, 1, (64, 64)).astype(np.float32)
    engine = PanopticDeepLabRenderEngine(tmodel, thing_list=[1], device="cpu")
    before = engine(img, img.shape)
    tmodel.train()
    np.testing.assert_array_equal(engine(img, img.shape), before)


# ---- the train forward -------------------------------------------------------


TRAIN_MODELS = [("PanopticDeepLabPR", TRAIN_PR, 64),
                ("PanopticDeepLabBC", TRAIN_PR, 64),
                ("PanopticBiFPNPR", SMALL_MINI, 128)]


@pytest.mark.parametrize("arch,kw,size", TRAIN_MODELS, ids=[a for a, _, _ in TRAIN_MODELS])
def test_train_forward_matches_jax(arch, kw, size):
    """JAX's train apply (its own point draws) against the port's train
    forward fed those points: every output and the new batch statistics."""
    model, variables = jax_init(arch, kw, size=size)
    tmodel = port_model(arch, kw, variables)
    x = _batch(2, size)["image"]
    rngs = {"points": jax.random.key(5), "dropout": jax.random.key(6)}
    want, mutated = jax.jit(lambda v, x: model.apply(
        v, x, train=True, rngs=rngs, mutable=["batch_stats"]))(variables, x)
    if arch == "PanopticDeepLabBC":
        coords = {k: torch.from_numpy(np.asarray(want[f"{k}_point_coords"]))
                  for k in ("sem", "cnt")}
    else:
        coords = torch.from_numpy(np.asarray(want["point_coords"]))
    got = tmodel(torch.from_numpy(x), train=True, point_coords=coords)
    assert sorted(got) == sorted(want)
    for k in want:
        _close(got[k].detach().numpy(), np.asarray(want[k]), 0, TRAIN_TOL)
    stats = _tensors(variables["params"], tmodel, mutated["batch_stats"])
    buffers = dict(tmodel.named_buffers())
    for name, t in stats.items():
        if name in buffers:
            _close(buffers[name].numpy(), t.numpy(), TOL, TRAIN_TOL / 2)


def test_point_sampling_replays_jax_draws():
    """``get_uncertain_point_coords_with_randomness`` on JAX's uniform
    draws picks JAX's points: the most uncertain 3/4, then the fresh ones."""
    from empanada_tpu.models.point_rend import (
        get_uncertain_point_coords_with_randomness as jax_points,
    )
    from empanada_tpu_torch.models.point_rend import (
        get_uncertain_point_coords_with_randomness as port_points,
    )

    logits = np.random.default_rng(2).normal(0, 2, (2, 16, 16, 1)).astype(np.float32)
    key = jax.random.key(9)
    want = jax_points(key, jnp.asarray(logits), 64, 3, 0.75)
    k1, k2 = jax.random.split(key)
    uniforms = (torch.from_numpy(np.asarray(jax.random.uniform(k1, (2, 192, 2)))),
                torch.from_numpy(np.asarray(jax.random.uniform(k2, (2, 16, 2)))))
    got = port_points(torch.from_numpy(logits), 64, 3, 0.75, uniforms=uniforms)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gen = torch.Generator().manual_seed(0)
    drawn = port_points(torch.from_numpy(logits), 64, 3, 0.75, generator=gen)
    assert drawn.shape == (2, 64, 2) and float(drawn.min()) >= 0 and float(drawn.max()) < 1


def test_aspp_dropout_is_flax_dropout():
    """Kept elements scaled by 1 / (1 - p), the rest 0, drawn from the
    generator; eval and p = 0 are the identity."""
    from empanada_tpu_torch.models.decoders import dropout

    x = torch.ones(4, 8, 16, 16)
    y = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert set(torch.unique(y).tolist()) == {0.0, 2.0}
    assert 0.4 < float((y > 0).float().mean()) < 0.6
    assert torch.equal(dropout(x, 0.0), x)
    y2 = dropout(x, 0.5, torch.Generator().manual_seed(0))
    assert torch.equal(y, y2)


# ---- losses ----------------------------------------------------------------


def _loss_case(bc, seed=4):
    rng = np.random.default_rng(seed)
    n, size, p = 2, 32, 48
    out = {"sem_logits": rng.normal(0, 2, (n, size, size, 1)).astype(np.float32),
           "sem_points": rng.normal(0, 2, (n, p, 1)).astype(np.float32)}
    coords = rng.random((n, p, 2)).astype(np.float32)
    coords[0, :4] = [[0.5 / size, 0.5 / size], [1.5 / size, 0.0], [0.0, 0.0], [0.999, 0.999]]
    if bc:
        out.update(cnt_logits=rng.normal(0, 2, (n, size, size, 1)).astype(np.float32),
                   cnt_points=rng.normal(0, 2, (n, p, 1)).astype(np.float32),
                   sem_point_coords=coords,
                   cnt_point_coords=rng.random((n, p, 2)).astype(np.float32))
    else:
        out.update(ctr_hmp=rng.random((n, size, size, 1)).astype(np.float32),
                   offsets=rng.normal(0, 2, (n, size, size, 2)).astype(np.float32),
                   point_coords=coords)
    return out, _batch(n, size, seed, bc=bc)


@pytest.mark.parametrize("bc", [False, True], ids=["PanopticLoss", "BCLoss"])
def test_losses_match_jax(bc):
    out, batch = _loss_case(bc)
    jax_loss, port_loss = (JT.BCLoss(), T.BCLoss()) if bc else (JT.PanopticLoss(),
                                                                  T.PanopticLoss())
    want_total, want_aux = jax_loss({k: jnp.asarray(v) for k, v in out.items()},
                                    {k: jnp.asarray(v) for k, v in batch.items()})
    got_total, got_aux = port_loss({k: torch.from_numpy(v) for k, v in out.items()},
                                   {k: torch.from_numpy(v) for k, v in batch.items()})
    assert sorted(got_aux) == sorted(want_aux)
    for k in want_aux:
        np.testing.assert_allclose(float(got_aux[k]), float(want_aux[k]), rtol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-6)


def test_multiclass_and_edge_losses():
    """Softmax CE with integer labels, the top-k fraction 1.0 (plain mean)
    and an empty offset mask (0)."""
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (2, 8, 8, 3)).astype(np.float32)
    labels = rng.integers(0, 3, (2, 8, 8)).astype(np.int32)
    for frac in (0.3, 1.0):
        np.testing.assert_allclose(
            float(T.bootstrap_ce(torch.from_numpy(logits), torch.from_numpy(labels), frac)),
            float(JT.bootstrap_ce(jnp.asarray(logits), jnp.asarray(labels), frac)), rtol=1e-6)
    pts = rng.normal(0, 2, (2, 10, 3)).astype(np.float32)
    coords = rng.random((2, 10, 2)).astype(np.float32)
    np.testing.assert_allclose(
        float(T.point_rend_loss(torch.from_numpy(pts), torch.from_numpy(coords),
                                torch.from_numpy(labels))),
        float(JT.point_rend_loss(jnp.asarray(pts), jnp.asarray(coords), jnp.asarray(labels))),
        rtol=1e-6)
    zero = T.offset_l1(torch.ones(1, 4, 4, 2), torch.zeros(1, 4, 4, 2), torch.zeros(1, 4, 4, 1))
    assert float(zero) == 0.0


# ---- one float32 step ------------------------------------------------------


@pytest.fixture(scope="module")
def pr_step():
    """JAX's loss, gradients and new batch statistics of one train step of
    the small PanopticDeepLabPR, and its points."""
    model, variables = jax_init("PanopticDeepLabPR", TRAIN_PR, size=64)
    batch = _batch(2, 64, seed=3)
    loss_fn = JT.PanopticLoss()
    rngs = {"points": jax.random.key(11)}

    @jax.jit
    def step(params, batch_stats, batch):
        def compute(params):
            out, mutated = model.apply({"params": params, "batch_stats": batch_stats},
                                       batch["image"], train=True, rngs=rngs,
                                       mutable=["batch_stats"])
            loss, aux = loss_fn(out, batch)
            return loss, (out["point_coords"], mutated["batch_stats"])
        return jax.value_and_grad(compute, has_aux=True)(params)

    (loss, (coords, new_bs)), grads = step(variables["params"], variables["batch_stats"],
                                           {k: jnp.asarray(v) for k, v in batch.items()})
    return dict(variables=variables, batch=batch, loss=float(loss),
                coords=np.asarray(coords), new_bs=jax.tree.map(np.asarray, new_bs),
                grads=jax.tree.map(np.asarray, grads))


def test_f32_step_matches_jax(pr_step):
    """Loss within 1e-5 relative; every gradient at rtol 1e-4 (module docstring);
    the new batch statistics at rtol 1e-5."""
    tmodel = port_model("PanopticDeepLabPR", TRAIN_PR, pr_step["variables"])
    batch = {k: torch.from_numpy(v) for k, v in pr_step["batch"].items()}
    out = tmodel(batch["image"], train=True,
                 point_coords=torch.from_numpy(pr_step["coords"]))
    loss, _ = T.PanopticLoss()(out, batch)
    loss.backward()
    np.testing.assert_allclose(float(loss), pr_step["loss"], rtol=TOL)
    want = _tensors(pr_step["grads"], tmodel, pr_step["new_bs"])
    buffers = dict(tmodel.named_buffers())
    n_grads = 0
    for name, p in tmodel.named_parameters():
        _close(p.grad.numpy(), want[name].numpy(), 1e-4, 1e-4)
        n_grads += 1
    for name, b in buffers.items():
        _close(b.numpy(), want[name].numpy(), TOL, TOL)
    assert n_grads == len(flatten_variables(pr_step["grads"]))


def test_remat_gives_identical_steps():
    """``remat`` recomputes the forward with the same draws (dropout 0.5
    and PointRend's points from the generator) and folds the batch into the
    running statistics once: parameters, statistics and losses bit-identical."""
    kw = dict(TRAIN_PR, aspp_dropout=0.5)
    _, variables = jax_init("PanopticDeepLabPR", kw, size=64)
    batch = {k: torch.from_numpy(v) for k, v in _batch(2, 64, seed=8).items()}
    results = []
    for remat in (False, True):
        tmodel = port_model("PanopticDeepLabPR", kw, variables)
        state = T.create_train_state(tmodel, T.onecycle_schedule(1e-3, 10), 0.1, seed=3)
        step = T.make_train_step(T.PanopticLoss(), remat=remat, amp=False)
        aux = [step(state, batch) for _ in range(2)]
        results.append((aux, tmodel.state_dict()))
    (aux0, sd0), (aux1, sd1) = results
    for a, b in zip(aux0, aux1):
        assert all(torch.equal(a[k], b[k]) for k in a)
    for k in sd0:
        assert torch.equal(sd0[k], sd1[k]), k


# ---- metrics -----------------------------------------------------------------


def _label_map(rng, shape, n, label_base=0):
    seg = np.zeros(shape, np.int64)
    for i in range(n):
        y, x = rng.integers(0, shape[0] - 6), rng.integers(0, shape[1] - 6)
        h, w = rng.integers(3, 12, 2)
        seg[y:y + h, x:x + w] = label_base + i + 1
    return seg


@pytest.mark.parametrize("n", [0, 5, 60])
def test_fast_matcher_matches_jax(n):
    """Dense, empty, and above 32 instances (the per-component solve)."""
    rng = np.random.default_rng(n)
    a = _label_map(rng, (96, 96), n)
    b = np.where(rng.random(a.shape) < 0.9, a, 0)
    b = np.roll(b, 1, axis=1)
    for kw in ({}, {"return_iou": True, "return_ioa": True}, {"iou_thr": 0.8}):
        got = fast_matcher(a, b, **kw)
        want = jax_fast_matcher(a, b, **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, (tuple, list)):
                for gi, wi in zip(g, w):
                    np.testing.assert_array_equal(gi, wi)
            else:
                np.testing.assert_array_equal(g, w)


def test_iou_pq_f1_match_jax():
    rng = np.random.default_rng(3)
    gt = _label_map(rng, (80, 80), 12, 1000)
    pred = np.where(rng.random(gt.shape) < 0.85, gt, 0)
    pred[40:50, 40:50] = 1099
    logits = rng.normal(0, 2, (2, 16, 16, 1)).astype(np.float32)
    sem = rng.integers(0, 2, (2, 16, 16))
    logits3 = rng.normal(0, 2, (2, 16, 16, 3)).astype(np.float32)
    for jm, tm, out, tgt in (
            (JT.IoU(JT.AverageMeter, [1]), T.IoU(T.AverageMeter, [1]),
             {"sem_logits": logits}, {"sem": sem}),
            (JT.IoU(JT.AverageMeter, [1, 2]), T.IoU(T.AverageMeter, [1, 2]),
             {"sem_logits": logits3}, {"sem": sem * 2}),
            (JT.PQ(JT.AverageMeter, [1], label_divisor=1000),
             T.PQ(T.AverageMeter, [1], label_divisor=1000),
             {"pan_seg": pred}, {"pan_seg": gt}),
            (JT.F1(JT.AverageMeter, [1], label_divisor=1000, iou_thr=0.5),
             T.F1(T.AverageMeter, [1], label_divisor=1000, iou_thr=0.5),
             {"pan_seg": pred}, {"pan_seg": gt})):
        assert tm.calculate(out, tgt) == jm.calculate(out, tgt)
    ema_j, ema_t = JT.EMAMeter(), T.EMAMeter()
    for v in (0.3, 0.5, 0.9):
        ema_j.update(v)
        ema_t.update(v)
    assert ema_t.avg == ema_j.avg
