"""The port's neural stone classifier (``models.neural``) against the JAX
reference on the CPU: the forward from the same parameters (and the
flatten order it depends on), flax's initialization, the loss and its
gradients, one AdamW step against optax's, the harvest's labels, training
to the reference test's accuracy, and the checkpoint."""

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F

from camkifu_tpu.models import neural as jneural
from camkifu_tpu_torch.models import neural

torch.set_num_threads(1)

#: Logits from the same parameters: both compute in bf16, whose products
#: and pools round in another order on each side (1.95e-3 measured on
#: logits up to 0.18).
LOGIT_ATOL = 4e-3

#: Labels are compared where the reference's top-2 logit margin exceeds
#: this (an untrained net has near-ties).
MARGIN = 0.02

#: Per leaf, the relative L2 distance of the port's gradient from the
#: reference's. Both backpropagate through bf16; measured 0.004–0.040 on
#: kernels and dense biases, 0.174 / 0.080 on the conv biases, which the
#: reference sums in bf16 (its conv-bias gradients are 0.183 / 0.083 from
#: the float32 net's, the port's 0.035 / 0.041).
GRAD_RTOL = {("Conv_0", "kernel"): 0.06, ("Conv_0", "bias"): 0.25,
             ("Conv_1", "kernel"): 0.06, ("Conv_1", "bias"): 0.12,
             ("Dense_0", "kernel"): 0.06, ("Dense_0", "bias"): 0.06,
             ("Dense_1", "kernel"): 0.06, ("Dense_1", "bias"): 0.06}

#: The port's gradient from the float32 twin's, every leaf (measured
#: 0.002–0.041).
F32_GRAD_RTOL = 0.06

#: One AdamW step against optax's from the same float32 parameters and
#: gradients, per leaf max|Δ| / max|param| (torch's default decay 1e-2
#: gives ~3e-5). The parameters are drawn with non-zero biases, so that
#: the decay of the biases is held too. (A leaf that starts at 0 moves by
#: lr·ĝ alone, and there optax's (1 − β₂ᵗ), rounded in float32, scales
#: the step by 1 − 8.8e-6 where torch's, in double, does not: 6.75e-6 of
#: the leaf measured.)
STEP_RTOL = 1e-6

LAYERS = ("Conv_0", "Conv_1", "Dense_0", "Dense_1")


def _flax(seed=0):
    _, params = jneural.init_params(jax.random.PRNGKey(seed))
    return params, jax.tree.map(np.asarray, params)


def _leaves(tree):
    return {(layer, leaf): np.asarray(tree["params"][layer][leaf])
            for layer in LAYERS for leaf in ("kernel", "bias")}


def _grads(model):
    """The port's parameter gradients in the flax layout."""
    out = {}
    for layer in LAYERS:
        m = getattr(model, layer)
        w = m.weight.grad
        w = w.permute(2, 3, 1, 0) if w.ndim == 4 else w.T
        out[layer, "kernel"] = w.numpy()
        out[layer, "bias"] = m.bias.grad.numpy()
    return out


def _f32_logits(model, x):
    """The same net in float32 throughout."""
    x = x.permute(0, 3, 1, 2)
    for conv in (model.Conv_0, model.Conv_1):
        x = F.avg_pool2d(F.relu(F.conv2d(x, conv.weight, conv.bias,
                                         padding=1)), 2)
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    x = F.relu(F.linear(x, model.Dense_0.weight, model.Dense_0.bias))
    return F.linear(x, model.Dense_1.weight, model.Dense_1.bias)


@pytest.mark.parametrize("flatten", ["nhwc", "nchw"])
def test_forward_matches_flax_and_needs_the_nhwc_flatten(flatten):
    """Flax's parameters through both nets: logits within LOGIT_ATOL and
    labels equal past the margin. Flattening the conv features in PyTorch's
    (c, h, w) order instead fails the same check."""
    params, tree = _flax()
    x = np.random.default_rng(1).random((256, 16, 16, 3), np.float32)
    ref = np.asarray(jneural.PatchNet().apply(params, jnp.asarray(x)))
    model = neural.params_from_jax(tree, device="cpu")
    with torch.no_grad():
        if flatten == "nhwc":
            ours = model(torch.from_numpy(x)).numpy()
        else:
            ours = model.head(model.trunk(torch.from_numpy(x))
                              .reshape(len(x), -1)).numpy()
    top2 = np.sort(ref, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > MARGIN
    err = float(np.abs(ours - ref).max())
    same = np.array_equal(ours.argmax(-1)[clear], ref.argmax(-1)[clear])
    assert ours.dtype == np.float32 and clear.sum() > 100
    if flatten == "nhwc":
        assert err <= LOGIT_ATOL and same, err
    else:
        assert err > 10 * LOGIT_ATOL and not same, err


def test_init_params_draws_flaxs_defaults():
    """lecun_normal kernels: per leaf, the std over 16 draws within 5% of
    flax's over 16 keys (one draw of the 3 × 128 Dense_1 kernel alone is
    ~4% off its distribution's), every weight within the ±2σ truncation;
    zero biases. The same generator seed draws the same net."""
    ours = [_leaves(neural.params_to_jax(neural.init_params(
        torch.Generator().manual_seed(s), device="cpu"))) for s in range(16)]
    init = jax.jit(jax.vmap(lambda k: jneural.init_params(k)[1]))
    many = jax.tree.map(np.asarray,
                        init(jax.random.split(jax.random.PRNGKey(0), 16)))
    ref = [_leaves(jax.tree.map(lambda a: a[i], many)) for i in range(16)]
    for layer in LAYERS:
        key = (layer, "kernel")
        assert ours[0][key].shape == ref[0][key].shape
        s_ours = np.concatenate([o[key].ravel() for o in ours]).std()
        s_ref = np.concatenate([r[key].ravel() for r in ref]).std()
        assert abs(s_ours / s_ref - 1) < 0.05, (layer, s_ours, s_ref)
        fan_in = int(np.prod(ours[0][key].shape[:-1]))
        bound = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert np.abs(ours[0][key]).max() <= bound * (1 + 1e-6)
        assert not ours[0][layer, "bias"].any()
    again = _leaves(neural.params_to_jax(neural.init_params(
        torch.Generator().manual_seed(0), device="cpu")))
    assert all(np.array_equal(again[k], ours[0][k]) for k in again)


def test_loss_and_gradients_match_jax():
    """``loss_fn`` and its gradients against ``jax.value_and_grad`` of the
    reference's from the same parameters and batch, and the port's
    gradients against the float32 twin's."""
    params, tree = _flax()
    rng = np.random.default_rng(2)
    x = rng.random((512, 16, 16, 3), np.float32)
    y = rng.integers(0, 3, 512)
    (loss_j, acc_j), grads_j = jax.value_and_grad(
        jneural.loss_fn, has_aux=True)(params, jneural.PatchNet(),
                                       jnp.asarray(x),
                                       jnp.asarray(y, jnp.int32))
    model = neural.params_from_jax(tree, device="cpu")
    loss, acc = neural.loss_fn(model, torch.from_numpy(x),
                               torch.from_numpy(y))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(loss_j), rel=1e-2)
    assert abs(float(acc) - float(acc_j)) <= 2 / 512
    twin = neural.params_from_jax(tree, device="cpu")
    F.cross_entropy(_f32_logits(twin, torch.from_numpy(x)),
                    torch.from_numpy(y)).backward()
    ours, ref, f32 = _grads(model), _leaves(grads_j), _grads(twin)
    for key, tol in GRAD_RTOL.items():
        err = np.linalg.norm(ours[key] - ref[key]) / np.linalg.norm(ref[key])
        assert err <= tol, (key, err)
        err = np.linalg.norm(ours[key] - f32[key]) / np.linalg.norm(f32[key])
        assert err <= F32_GRAD_RTOL, (key, err)


@pytest.mark.parametrize("weight_decay", [1e-4, 1e-2])
def test_adamw_step_matches_optax(weight_decay):
    """One step from the same float32 parameters and gradients: the port's
    optimizer equals ``optax.adamw(3e-3)`` within STEP_RTOL on every leaf;
    torch's default decay of 1e-2 does not."""
    rng = np.random.default_rng(3)
    tree = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape))
        .astype(np.float32), _flax()[1])
    params = jax.tree.map(jnp.asarray, tree)
    grads = jax.tree.map(
        lambda a: (0.01 * rng.standard_normal(a.shape)).astype(np.float32),
        tree)
    tx = optax.adamw(3e-3)
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = _leaves(jax.tree.map(np.asarray,
                               optax.apply_updates(params, updates)))
    model = neural.params_from_jax(tree, device="cpu")
    opt = neural.make_optimizer(model, 3e-3)
    if weight_decay != 1e-4:
        opt = torch.optim.AdamW(model.parameters(), lr=3e-3,
                                weight_decay=weight_decay)
    g = neural.params_from_jax(grads, device="cpu")
    for p, gp in zip(model.parameters(), g.parameters()):
        p.grad = gp.detach().clone()
    opt.step()
    ours = _leaves(neural.params_to_jax(model))
    worst = max(np.abs(ours[k] - ref[k]).max() / np.abs(ref[k]).max()
                for k in ref)
    if weight_decay == 1e-4:
        assert worst <= STEP_RTOL, worst
    else:
        assert worst > 10 * STEP_RTOL, worst


def test_harvest_labels_match_the_reference():
    """The same seed draws the same boards, rendered by the port's synth
    with the reference's palettes and degradations: labels bitwise equal
    to the reference harvest's (3 boards at 360×640, each depending on
    every draw of the ones before), patches (N, 16, 16, 3) float32 in
    [0, 1] within a mean of 0.02 and a 99th percentile of 0.1 of the
    reference's (3.3 and 15.7 DN measured: the sensor noise is drawn on
    the device, and anti-aliased rims differ)."""
    hw = (360, 640)
    patches_j, labels_j = jneural.harvest_patches(n_boards=3, frame_hw=hw,
                                                  seed=5)
    patches, labels = neural.harvest_patches(n_boards=3, frame_hw=hw,
                                             seed=5, device="cpu")
    assert np.array_equal(labels.numpy(), labels_j)
    assert labels.dtype == torch.int64
    assert patches.shape == patches_j.shape == (1083, 16, 16, 3)
    assert patches.dtype == torch.float32
    assert 0.0 <= float(patches.min()) and float(patches.max()) <= 1.0
    d = np.abs(patches.numpy() - np.asarray(patches_j))
    assert d.mean() < 0.02 and np.percentile(d, 99) < 0.1, \
        (d.mean(), np.percentile(d, 99))
    specs = neural._harvest_specs(3, hw, 5)
    assert [s[2]["palette"] for s in specs] == ["bamboo", "kaya", "walnut"]


@pytest.fixture(scope="module")
def dataset():
    return neural.harvest_patches(n_boards=6, frame_hw=(480, 854), seed=3,
                                  device="cpu")


def test_train_reaches_high_accuracy(dataset):
    """The reference test's run on the port's own harvest: 6 boards at
    480×854, 4 epochs of batches of 512: accuracy > 0.97, as there."""
    patches, labels = dataset
    assert len(patches) == 6 * 361
    assert set(np.unique(labels.numpy())) == {0, 1, 2}
    model, acc = neural.train(patches, labels, epochs=4, batch=512)
    assert acc > 0.97
    with torch.no_grad():
        held = (model(patches).argmax(-1) == labels).float().mean()
    assert float(held) > 0.97


def test_checkpoint_roundtrip_and_the_flax_layout(tmp_path):
    """``save_params`` / ``load_params`` bitwise; an ``np.savez`` of
    flattened flax parameters loads as it is; a file with a missing or an
    extra leaf is refused; no file gives None."""
    model = neural.init_params(torch.Generator().manual_seed(7),
                               device="cpu")
    path = str(tmp_path / "sub" / "net.npz")
    neural.save_params(model, path)
    back = neural.load_params(path, device="cpu")
    for a, b in zip(model.state_dict().values(), back.state_dict().values()):
        assert torch.equal(a, b)
    assert neural.load_params(str(tmp_path / "none.npz"), "cpu") is None

    _, tree = _flax(1)
    flat = {f"params/{layer}/{leaf}": tree["params"][layer][leaf]
            for layer in LAYERS for leaf in ("kernel", "bias")}
    np.savez(tmp_path / "jax.npz", **flat)
    loaded = neural.load_params(str(tmp_path / "jax.npz"), device="cpu")
    got = _leaves(neural.params_to_jax(loaded))
    assert all(np.array_equal(got[k], _leaves(tree)[k]) for k in got)
    for bad in ({k: v for k, v in flat.items()
                 if k != "params/Dense_1/bias"},
                dict(flat, **{"params/Dense_2/bias": np.zeros(3)})):
        np.savez(tmp_path / "bad.npz", **bad)
        with pytest.raises(ValueError):
            neural.load_params(str(tmp_path / "bad.npz"), device="cpu")


def test_main_trains_and_saves(tmp_path, capsys):
    """The trainer's entry point on the CPU, one board and one epoch, and
    with ``--sharded`` (``parallel/train.py`` in a gloo world of one, whose
    net is the same as the single-process one's)."""
    out = str(tmp_path / "ckpt.npz")
    assert neural.main(["--boards", "1", "--epochs", "1", "--out", out],
                       device="cpu") == 0
    assert neural.load_params(out, device="cpu") is not None
    assert "361 patches; training (batch 256)" in capsys.readouterr().out
    out_sh = str(tmp_path / "sharded.npz")
    assert neural.main(["--boards", "1", "--epochs", "1", "--out", out_sh,
                        "--sharded", "--device", "cpu"]) == 0
    assert "361 patches; training (batch 256)" in capsys.readouterr().out
    a, b = (neural.load_params(p, device="cpu") for p in (out, out_sh))
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        assert torch.equal(x, y)
