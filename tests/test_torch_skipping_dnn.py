"""The port's enhancer and trainer against the JAX package's, with the
reference's initial parameters and batch indices carried across: the
forward, the gradients of the training loss, and one epoch of training.
Conv and GEMM sums run in another order in each framework, so these agree
within float32 tolerances, not bit for bit."""
import jax
import numpy as np
import pytest
import torch

from repro.core import online_trainer as ref_trainer
from repro.core import skipping_dnn as ref_dnn
from repro_torch.core import online_trainer as port_trainer
from repro_torch.core import skipping_dnn as port_dnn

# The suite runs in parallel workers on a few cores: one intra-op thread
# per worker keeps the port's tests from crowding out the others.
torch.set_num_threads(1)

def _nets(c_in=1, regulated=True, skip=True, seed=3):
    ref_cfg = ref_dnn.SkippingDNNConfig(c_in=c_in, regulated=regulated, skip=skip)
    ref_params = ref_dnn.init_params(jax.random.PRNGKey(seed), ref_cfg)
    model = port_dnn.SkippingDNN(
        port_dnn.SkippingDNNConfig(c_in=c_in, regulated=regulated, skip=skip),
        port_dnn.params_from_jax(jax.tree.map(np.asarray, ref_params)),
        device="cpu")
    return ref_params, model


def test_param_count_is_the_papers():
    model = port_dnn.SkippingDNN(port_dnn.SkippingDNNConfig(c_in=1), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == 3073


@pytest.mark.parametrize("c_in,regulated,skip,hw", [
    (1, True, True, (17, 13)), (2, False, False, (16, 16))])
def test_forward_matches_reference(c_in, regulated, skip, hw):
    ref_params, model = _nets(c_in, regulated, skip)
    x = np.random.default_rng(c_in).standard_normal((3, *hw, c_in)).astype(np.float32)
    want = np.asarray(ref_dnn.forward(ref_params, x, regulated=regulated,
                                      skip=skip, lowering="eager"))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, *hw, 1)
    # Ten float32 layers, sums reordered: ~1e-6 relative per layer.
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("c_in,regulated,skip,hw", [
    (1, True, True, (17, 13)), (2, False, False, (16, 16))])
def test_apply_matches_reference(c_in, regulated, skip, hw):
    ref_params, model = _nets(c_in, regulated, skip)
    x = np.random.default_rng(c_in).standard_normal((3, *hw, c_in)).astype(np.float32)
    ref_cfg = ref_dnn.SkippingDNNConfig(c_in=c_in, regulated=regulated, skip=skip)
    want = np.asarray(ref_dnn.apply(ref_params, x, ref_cfg))
    with torch.no_grad():
        got = port_dnn.apply(model.tree(), torch.from_numpy(x), model.cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_grads_match_jax_grad():
    ref_params, model = _nets()
    rng = np.random.default_rng(22)
    xb = rng.standard_normal((4, 20, 24, 1)).astype(np.float32)
    yb = np.clip(rng.standard_normal((4, 20, 24, 1)), -1, 1).astype(np.float32)
    want_loss, want = jax.value_and_grad(ref_trainer.batch_loss)(
        ref_params, xb, yb, regulated=True, skip=True, loss="mse",
        lowering="eager")
    loss = port_trainer.batch_loss(model, torch.from_numpy(xb),
                                   torch.from_numpy(yb))
    grads = dict(zip([n for n, _ in model.named_parameters()],
                     torch.autograd.grad(loss, list(model.parameters()))))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for name in port_dnn.LAYERS:
        for k in ("b", "w"):
            g = grads[f"{name}.{k}"].numpy()
            w = np.asarray(want[name][k])
            # Back through ten float32 layers in another summation order:
            # 1e-4 of the layer's largest gradient.
            np.testing.assert_allclose(g, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max())


def test_one_epoch_matches_reference_train():
    ref_params, model = _nets(seed=9)
    n, batch = 8, 4
    rng = np.random.default_rng(23)
    inputs = rng.standard_normal((n, 16, 20, 1)).astype(np.float32)
    targets = np.clip(rng.standard_normal((n, 16, 20, 1)) * 0.5, -1, 1
                      ).astype(np.float32)
    ref_cfg = ref_trainer.TrainConfig(epochs=1, batch=batch, seed=4,
                                      lowering="eager")
    want, _, want_hist = ref_trainer.train(
        ref_params, inputs, targets, ref_cfg,
        ref_dnn.SkippingDNNConfig(c_in=1))
    batches = np.asarray(ref_trainer.epoch_batches(
        jax.random.fold_in(jax.random.PRNGKey(4), 0), n, n // batch, batch))
    hist = port_trainer.train(
        model, inputs, targets, port_trainer.TrainConfig(epochs=1, batch=batch),
        schedule=batches[None])
    np.testing.assert_allclose(hist, want_hist, rtol=1e-5)
    got = model.tree()
    for name in port_dnn.LAYERS:
        for k in ("b", "w"):
            # Two Adam steps at lr 1e-2 move each weight by about 2e-2.
            # Adam divides by the gradient's own scale, so a float32 sum
            # order shows up as ~1e-6 here; 1e-4 is 1% of one step.
            np.testing.assert_allclose(got[name][k].detach().numpy(),
                                       np.asarray(want[name][k]),
                                       rtol=0, atol=1e-4)


def test_train_rejects_a_schedule_of_the_wrong_shape():
    _, model = _nets()
    x = np.zeros((6, 16, 16, 1), np.float32)
    with pytest.raises(ValueError, match="schedule"):
        port_trainer.train(model, x, x, port_trainer.TrainConfig(epochs=2, batch=3),
                           schedule=np.zeros((1, 2, 3), np.int64))
