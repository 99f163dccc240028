"""Data + model parallel training (``parallel/train.py``) on four gloo
processes on the CPU, 2 data × 2 model, against the JAX reference's
``make_train_step`` on a 2 × 2 mesh of the CPU's forced host devices:
the same parameters (carried across by ``params_from_jax``) and batches,
losses and per-leaf gradients to tests/test_torch_neural.py's rounding
bounds; ``train_sharded`` to the reference test's accuracy; each rank
holding half of ``Dense_0``'s columns. Every process has a join timeout,
so a hung rank fails the test."""

import multiprocessing
import queue

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch
import torch.nn.functional as F
from jax.sharding import NamedSharding, PartitionSpec as P

from camkifu_tpu.models import neural as jneural
from camkifu_tpu.parallel import train as jtrain
from camkifu_tpu_torch.models import neural
from camkifu_tpu_torch.parallel import train as ptrain

torch.set_num_threads(1)

WORLD = 4
LAYERS = ("Conv_0", "Conv_1", "Dense_0", "Dense_1")
STEPS = 3
BATCH = 512

#: Seconds a rank may take, its imports included.
JOIN_S = 180

#: tests/test_torch_neural.py's bounds: losses within 1e-2 relative; per
#: leaf, the relative L2 distance of the port's gradient from the
#: reference's (both backpropagate through bf16; the reference sums the
#: conv biases in bf16) and from the float32 net's. On this batch the
#: reference's conv-bias gradients are 0.252 / 0.140 from the float32
#: net's, sharded or not, the port's 0.032 / 0.040, so Conv_1's bias is
#: held to 0.16 here (measured 0.150), not test_torch_neural.py's 0.12.
LOSS_RTOL = 1e-2
GRAD_RTOL = {("Conv_0", "kernel"): 0.06, ("Conv_0", "bias"): 0.25,
             ("Conv_1", "kernel"): 0.06, ("Conv_1", "bias"): 0.16,
             ("Dense_0", "kernel"): 0.06, ("Dense_0", "bias"): 0.06,
             ("Dense_1", "kernel"): 0.06, ("Dense_1", "bias"): 0.06}
F32_GRAD_RTOL = 0.06

#: The sharded gradients from the port's single-process ones on the same
#: batch: the split only reorders bf16 sums (measured 0.002–0.003).
SPLIT_GRAD_RTOL = 0.01

#: tests/test_neural.py's bar for the reference's sharded training.
SHARDED_ACC = 0.95


#: The torch-layout dimension each split gradient is gathered along:
#: Dense_0's output rows (weight and bias), Dense_1's input columns.
SPLIT_DIM = {("Dense_0", "kernel"): 0, ("Dense_0", "bias"): 0,
             ("Dense_1", "kernel"): 1}


def _full_grads(model, mesh):
    """The gradients of a ShardedPatchNet in the flax layout, each split
    leaf gathered over the model group."""
    import torch.distributed as dist

    out = {}
    for layer in LAYERS:
        m = getattr(model, layer)
        for leaf, t in (("kernel", m.weight.grad), ("bias", m.bias.grad)):
            if (layer, leaf) in SPLIT_DIM:
                parts = [torch.empty_like(t) for _ in range(2)]
                dist.all_gather(parts, t.contiguous(),
                                group=mesh.model_group)
                t = torch.cat(parts, dim=SPLIT_DIM[layer, leaf])
            if t.ndim == 4:                               # OIHW → HWIO
                t = t.permute(2, 3, 1, 0)
            elif t.ndim == 2:                       # (out, in) → (in, out)
                t = t.T
            out[layer, leaf] = t.numpy().copy()
    return out


def _rank(rank, port, tree, x, y, order, patches, labels, results):
    """One gloo rank: the reference's three steps from its parameters,
    then ``train_sharded`` on the harvest."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        mesh = ptrain.make_mesh(WORLD, model_parallel=2)
        model = ptrain.shard_model(neural.params_from_jax(tree, "cpu"), mesh)
        step = ptrain.make_train_step(mesh, neural.make_optimizer(model),
                                      model)
        losses, grads = [], None
        for i in range(STEPS):
            sel = torch.from_numpy(order[i * BATCH:(i + 1) * BATCH])
            loss, _ = step(torch.from_numpy(x)[sel], torch.from_numpy(y)[sel])
            losses.append(float(loss))
            if i == 0:
                grads = _full_grads(model, mesh)
        try:
            step(torch.from_numpy(x)[:BATCH - 1],
                 torch.from_numpy(y)[:BATCH - 1])
            uneven = None
        except ValueError as exc:
            uneven = str(exc)
        trained, acc = ptrain.train_sharded(
            torch.from_numpy(patches), torch.from_numpy(labels), mesh=mesh,
            epochs=3, batch=BATCH)
        results.put((rank, {"mesh": (mesh.shape, mesh.data_index,
                                     mesh.model_index),
                            "losses": losses, "grads": grads, "acc": acc,
                            "uneven": uneven,
                            "dense0": tuple(trained.Dense_0.weight.shape)}))
    finally:
        dist.destroy_process_group()


def _reference(tree, x, y, order):
    """The reference's sharded step on a 2 × 2 mesh: the losses of three
    steps and the first step's gradients."""
    mesh = jtrain.make_mesh(jax.devices()[:WORLD], model_parallel=2)
    assert mesh.shape == {"data": 2, "model": 2}
    params = jax.tree.map(jnp.asarray, tree)
    params = jax.tree.map(jax.device_put, params,
                          jtrain.param_sharding(params, mesh))
    tx = optax.adamw(3e-3)
    opt_state = tx.init(params)
    model = jneural.PatchNet()
    step = jtrain.make_train_step(mesh, tx, model)
    data_sh = NamedSharding(mesh, P("data"))
    grad_fn = jax.jit(jax.value_and_grad(jneural.loss_fn, has_aux=True),
                      static_argnums=1)
    losses, grads = [], None
    with mesh:
        for i in range(STEPS):
            sel = order[i * BATCH:(i + 1) * BATCH]
            px = jax.device_put(jnp.asarray(x[sel]), data_sh)
            ly = jax.device_put(jnp.asarray(y[sel], jnp.int32), data_sh)
            if i == 0:
                _, g = grad_fn(params, model, px, ly)
                grads = {(layer, leaf): np.asarray(g["params"][layer][leaf])
                         for layer in LAYERS for leaf in ("kernel", "bias")}
            params, opt_state, loss, _ = step(params, opt_state, px, ly)
            losses.append(float(loss))
    return losses, grads


@pytest.fixture(scope="module")
def runs():
    """The four ranks' results and the reference's, on random patches
    for the steps and the port's harvest for the training."""
    _, params = jneural.init_params(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(2)
    x = rng.random((STEPS * BATCH, 16, 16, 3), np.float32)
    y = rng.integers(0, 3, STEPS * BATCH)
    order = rng.permutation(STEPS * BATCH)
    patches, labels = neural.harvest_patches(n_boards=6, frame_hw=(480, 854),
                                             seed=3, device="cpu")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = ptrain.free_port()
    procs = [ctx.Process(target=_rank, args=(
        r, port, tree, x, y, order, patches.numpy(), labels.numpy(),
        results)) for r in range(WORLD)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in range(WORLD):
            rank, out = results.get(timeout=JOIN_S)
            got[rank] = out
    except queue.Empty:
        pass
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
    assert sorted(got) == list(range(WORLD)), \
        f"ranks {sorted(got)} of {WORLD} finished within {JOIN_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return got, _reference(tree, x, y, order), _single(tree, x, y, order)


def _single(tree, x, y, order):
    """The first step's gradients of the port's single-process net and of
    its float32 twin, in the flax layout."""
    sel = torch.from_numpy(order[:BATCH])
    xs, ys = torch.from_numpy(x)[sel], torch.from_numpy(y)[sel]
    model = neural.params_from_jax(tree, "cpu")
    neural.loss_fn(model, xs, ys)[0].backward()
    twin = neural.params_from_jax(tree, "cpu")
    h = xs.permute(0, 3, 1, 2)
    for conv in (twin.Conv_0, twin.Conv_1):
        h = F.avg_pool2d(F.relu(F.conv2d(h, conv.weight, conv.bias,
                                         padding=1)), 2)
    h = h.permute(0, 2, 3, 1).reshape(len(xs), -1)
    h = F.relu(F.linear(h, twin.Dense_0.weight, twin.Dense_0.bias))
    F.cross_entropy(F.linear(h, twin.Dense_1.weight, twin.Dense_1.bias),
                    ys).backward()
    out = []
    for net in (model, twin):
        tree = {}
        for layer in LAYERS:
            m = getattr(net, layer)
            w = m.weight.grad
            tree[layer, "kernel"] = (w.permute(2, 3, 1, 0) if w.ndim == 4
                                     else w.T).numpy()
            tree[layer, "bias"] = m.bias.grad.numpy()
        out.append(tree)
    return out


def test_mesh_layout_matches_the_reference(runs):
    """Rank r at (r // 2, r % 2) of a {"data": 2, "model": 2} mesh, as the
    reference reshapes its devices; each rank's Dense_0 weight holds half
    of the 128 columns (torch's (out, in) rows) after training; a batch
    that does not split over the data ranks is refused, as the
    reference's sharding refuses it."""
    got = runs[0]
    for r, out in got.items():
        assert out["mesh"] == ({"data": 2, "model": 2}, r // 2, r % 2)
        assert out["dense0"] == (64, 1024)
        assert out["uneven"] == f"a batch of {BATCH - 1} does not split " \
            "over 2 data ranks"


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_steps_match_the_reference(runs):
    """Three steps from the same parameters and batches: every rank's loss
    (the whole batch's) within LOSS_RTOL of the reference's; the first
    step's gradients, gathered, on every rank within GRAD_RTOL of the
    reference's, F32_GRAD_RTOL of the float32 net's and SPLIT_GRAD_RTOL of
    the port's single-process ones, per leaf."""
    got, (ref_losses, ref_grads), (single, f32) = runs
    for r, out in got.items():
        np.testing.assert_allclose(out["losses"], ref_losses, rtol=LOSS_RTOL)
        for key, tol in GRAD_RTOL.items():
            ours = out["grads"][key]
            assert ours.shape == ref_grads[key].shape, key
            assert _rel(ours, ref_grads[key]) <= tol, (r, key)
            assert _rel(ours, f32[key]) <= F32_GRAD_RTOL, (r, key)
            assert _rel(ours, single[key]) <= SPLIT_GRAD_RTOL, (r, key)


def test_train_sharded_learns(runs):
    """``train_sharded`` on 6 harvested boards, 3 epochs of 512: accuracy
    above the reference test's 0.95, the same on every rank."""
    accs = {out["acc"] for out in runs[0].values()}
    assert len(accs) == 1 and accs.pop() > SHARDED_ACC
