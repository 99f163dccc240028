"""The port's neural finder (``stone.sf_neural``) and SfMeta's third voter
against the JAX reference on the CPU, with one net trained by the port and
carried to JAX with ``params_to_jax``: ``classify_batch_neural`` with
fixed and per-frame corners, ``sf_meta.read_batch(neural_params=...)`` over
a game, and the finder classes picking up a checkpoint."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.core.gamesync import MoveExtractor, score_moves
from camkifu_tpu.stone import sf_meta as jmeta
from camkifu_tpu.stone.sf_neural import \
    classify_batch_neural as jclassify
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.models import neural
from camkifu_tpu_torch.stone import sf_meta, sf_neural

torch.set_num_threads(1)

HW = (480, 854)

#: Top softmax probability against the reference's from the same net: the
#: bf16 logits differ by ~2e-3 (tests/test_torch_neural.py) and the two
#: warps by 5e-5.
CONF_ATOL = 3e-3


@pytest.fixture(scope="module")
def net():
    """tests/test_neural.py's training run on the port's harvest (6 boards
    at 480×854, 4 epochs of 512), and the same net as a flax tree."""
    patches, labels = neural.harvest_patches(n_boards=6, frame_hw=HW,
                                             seed=3, device="cpu")
    model, acc = neural.train(patches, labels, epochs=4, batch=512)
    assert acc > 0.97
    return model, jax.tree.map(jnp.asarray, neural.params_to_jax(model))


def _board():
    """tests/test_neural.py's board: 70 stones (seed 9), rendered at seed
    31."""
    board = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(9).choice(361, 70, replace=False)
    board.flat[idx[::2]] = 1
    board.flat[idx[1::2]] = 2
    frame, corners = synth.render_frame(board, frame_hw=HW, seed=31)
    return board, frame, corners


@pytest.mark.parametrize("per_frame", [False, True])
def test_classify_batch_neural_matches_jax(net, per_frame):
    """Fixed corners, and 4 frames each with its own corners (through
    ``warp_batch_chunked``): labels equal to the reference's, confidences
    within CONF_ATOL, and the board read."""
    model, params = net
    board, frame, corners = _board()
    frames = np.repeat(frame[None], 4 if per_frame else 1, 0)
    if per_frame:
        shift = np.array([[0.0, 0.0], [0.4, -0.3], [-0.5, 0.2],
                          [0.3, 0.5]], np.float32)
        corners = (corners[None] + shift[:, None]).astype(np.float32)
    lab_j, conf_j = jclassify(params, jnp.asarray(frames),
                              jnp.asarray(corners))
    lab, conf = sf_neural.classify_batch_neural(
        model, torch.from_numpy(frames), torch.from_numpy(corners))
    assert lab.dtype == torch.int8 and conf.dtype == torch.float32
    assert lab.shape == (len(frames), 19, 19)
    assert np.array_equal(lab.numpy(), np.asarray(lab_j))
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_j),
                               atol=CONF_ATOL, rtol=0)
    assert (lab.numpy() == board).mean() > 0.97


def test_meta_read_batch_with_the_voter_matches_jax(net):
    """tests/test_neural.py's 6-move game (seed 15) through both packages'
    ``sf_meta.read_batch`` with the net as third voter, in batches of 16,
    the last padded: labels equal on every frame, and the game read
    exactly."""
    model, params = net
    moves = synth.sample_moves(6, seed=15)
    frames = [f for f, _ in synth.render_game(
        moves, frames_per_move=9, frame_hw=HW, empty_leadin=4)]
    corners = synth.default_corners(HW)
    state_t = sf_meta.init_state(device="cpu")
    state_j = jmeta.init_state()
    ex = MoveExtractor()
    for i in range(0, len(frames), 16):
        chunk = frames[i:i + 16]
        n = len(chunk)
        chunk = np.stack(chunk + [chunk[-1]] * (16 - n))
        state_j, lab_j, _, _ = jmeta.read_batch(
            state_j, jnp.asarray(chunk), jnp.asarray(corners),
            neural_params=params)
        state_t, lab, _, _ = sf_meta.read_batch(
            state_t, torch.from_numpy(chunk), torch.from_numpy(corners),
            neural_params=model)
        assert np.array_equal(lab.numpy(), np.asarray(lab_j)), i
        for j in range(n):
            ex.advance(lab[j].numpy())
    assert score_moves(ex.moves, moves)["agreement"] == 1.0


class _Host:
    """A manager: its device, no controller, no board finder."""

    controller = None
    board_finder = None
    device = torch.device("cpu")


def test_finders_pick_up_the_ports_checkpoint(net, tmp_path, monkeypatch):
    """SfMeta takes a checkpoint at ``NEURAL_CKPT`` as its third voter,
    with its parameters; SfNeural loads the one in the home directory
    rather than train."""
    model, _ = net
    path = str(tmp_path / "sf_neural.npz")
    monkeypatch.setattr(sf_meta, "NEURAL_CKPT", path)
    monkeypatch.setattr(sf_meta, "JAX_NEURAL_CKPT", str(tmp_path / "jax"))
    assert sf_meta.SfMeta(_Host()).neural_params is None
    neural.save_params(model, path)
    sf = sf_meta.SfMeta(_Host())
    assert isinstance(sf.neural_params, neural.PatchNet)
    assert sf.metadata["neural"] == "on"
    for a, b in zip(model.state_dict().values(),
                    sf.neural_params.state_dict().values()):
        assert torch.equal(a, b)
    monkeypatch.setenv("HOME", str(tmp_path))
    neural.save_params(model, neural.DEFAULT_CKPT)
    finder = sf_neural.SfNeural(_Host())
    assert "train" not in finder.metadata
    assert torch.equal(finder.params.Dense_1.weight, model.Dense_1.weight)
