"""Neural stone classifier (port of camkifu_tpu/models/neural.py): a small
CNN over intersection patches, its trainer, patch harvesting from rendered
boards, and the checkpoint.

    python -m camkifu_tpu_torch.models.neural [--boards 48] [--epochs 6]

trains on the card and writes the checkpoint that ``stone.sf_neural`` and
SfMeta's third voter read. ``main(argv, device="cpu")`` trains on the CPU.

The net computes as the reference's flax module does: float32 parameters
and logits, every convolution and product in bfloat16 (explicit casts, not
``torch.autocast``, whose per-op policy is its own), the bias added after
the bf16 product, and the conv features flattened in (h, w, c) order. The
parameters start from flax's defaults (``lecun_normal`` kernels, zero
biases) and are trained by AdamW with optax's defaults. A checkpoint is an
``.npz`` of the flax layout (``params/Conv_0/kernel`` (3, 3, 3, 32), …), so
a numpy dump of the reference's parameters loads as it is
(``params_from_jax`` / ``params_to_jax`` convert in memory).

Boards are drawn by the port's ``utils/synth.py`` on the device, with the
reference's calls: palettes cycled, and its lighting, blur, shadow, grain,
vignetting, glare and shot noise drawn for each board in its order, so
each board's labels, perspective, looks and corner error are the
reference's for the same seed. Departure: the checkpoint is an ``.npz``,
not an orbax directory. ``--sharded`` (dp + tp over a mesh, ``parallel/train.py``) is not
ported.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from camkifu_tpu_torch.config import cvconf

NUM_CLASSES = 3   # 0=E, 1=B, 2=W

#: flax's ``lecun_normal``: a normal truncated at ±2σ, scaled so that the
#: truncated draw has variance 1 / fan_in.
_TRUNC_STD = 0.87962566103423978

#: Boards warped in one launch while harvesting.
HARVEST_CHUNK = 16


def _leaf_shapes(features: int = 32, zone: int = cvconf.zone_size) -> dict:
    """The flax layout's leaves: {layer: {"kernel": shape, "bias": shape}}
    (conv kernels HWIO, dense kernels (in, out))."""
    f = features
    flat = (zone // 4) ** 2 * 2 * f
    return {"Conv_0": {"kernel": (3, 3, 3, f), "bias": (f,)},
            "Conv_1": {"kernel": (3, 3, f, 2 * f), "bias": (2 * f,)},
            "Dense_0": {"kernel": (flat, 4 * f), "bias": (4 * f,)},
            "Dense_1": {"kernel": (4 * f, NUM_CLASSES),
                        "bias": (NUM_CLASSES,)}}


class PatchNet(nn.Module):
    """Tiny CNN: (N, z, z, 3) patches → (N, 3) float32 logits. conv 3×3 →
    f, ReLU, 2×2 average pool, conv 3×3 → 2f, ReLU, 2×2 average pool,
    flatten, dense 4f, ReLU, dense 3; computed in bf16, parameters float32.
    Layers keep the flax names. Made empty: ``init_params`` draws the
    parameters, ``params_from_jax`` / ``load_params`` set them."""

    def __init__(self, features: int = 32, zone: int = cvconf.zone_size):
        super().__init__()
        f = features
        meta = {"device": "meta"}          # no draw from the global RNG
        self.Conv_0 = nn.Conv2d(3, f, 3, padding=1, **meta)
        self.Conv_1 = nn.Conv2d(f, 2 * f, 3, padding=1, **meta)
        self.Dense_0 = nn.Linear((zone // 4) ** 2 * 2 * f, 4 * f, **meta)
        self.Dense_1 = nn.Linear(4 * f, NUM_CLASSES, **meta)

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """(N, z, z, 3) → the pooled conv features (N, 2f, z/4, z/4) bf16,
        NCHW."""
        bf = torch.bfloat16
        x = x.to(bf).permute(0, 3, 1, 2)
        for conv in (self.Conv_0, self.Conv_1):
            x = F.conv2d(x, conv.weight.to(bf), padding=1) \
                + conv.bias.to(bf)[:, None, None]
            x = F.avg_pool2d(F.relu(x), 2)
        return x

    def head(self, flat: torch.Tensor) -> torch.Tensor:
        """Flattened features (N, (z/4)²·2f) bf16 → float32 logits."""
        bf = torch.bfloat16
        x = F.relu(F.linear(flat, self.Dense_0.weight.to(bf))
                   + self.Dense_0.bias.to(bf))
        x = F.linear(x, self.Dense_1.weight.to(bf)) + self.Dense_1.bias.to(bf)
        return x.to(torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.trunk(x)
        # flax flattens NHWC activations: Dense_0's rows are (h, w, c).
        return self.head(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1))


def _empty(zone: int, device) -> PatchNet:
    return PatchNet(zone=zone).to_empty(device=device)


def init_params(generator: torch.Generator, zone: int = cvconf.zone_size,
                device="cuda") -> PatchNet:
    """A PatchNet on ``device`` with flax's default initialization, drawn
    on the CPU from ``generator``: kernels ``lecun_normal`` (std
    √(1/fan_in), fan_in 27, 288, 1,024, 128), biases zero."""
    model = _empty(zone, "cpu")
    with torch.no_grad():
        for layer in (model.Conv_0, model.Conv_1, model.Dense_0,
                      model.Dense_1):
            w = layer.weight
            std = math.sqrt(1.0 / (w.numel() // w.shape[0])) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            layer.bias.zero_()
    return model.to(device)


def params_from_jax(tree: dict, device="cuda") -> PatchNet:
    """A PatchNet on ``device`` holding a flax-layout tree of arrays
    (``{"params": {"Conv_0": {"kernel": (3, 3, 3, 32), "bias"}, …}}``).
    Refuses a tree whose leaves are missing, extra or of another shape."""
    params = tree.get("params") if isinstance(tree, dict) else None
    want = _leaf_shapes()
    if not isinstance(params, dict) or set(params) != set(want) or any(
            not isinstance(params[k], dict) or set(params[k]) != set(v)
            for k, v in want.items()):
        raise ValueError(f"not a PatchNet parameter tree: want "
                         f"{{'params': {want}}}")
    model = _empty(cvconf.zone_size, "cpu")
    with torch.no_grad():
        for name, leaves in want.items():
            layer = getattr(model, name)
            for leaf, shape in leaves.items():
                a = np.array(params[name][leaf], np.float32)
                if a.shape != shape:
                    raise ValueError(f"params/{name}/{leaf} has shape "
                                     f"{a.shape}, want {shape}")
                t = torch.from_numpy(a)
                if leaf == "bias":
                    layer.bias.copy_(t)
                elif t.ndim == 4:                      # HWIO → OIHW
                    layer.weight.copy_(t.permute(3, 2, 0, 1))
                else:                                  # (in, out) → (out, in)
                    layer.weight.copy_(t.T)
    return model.to(device)


def params_to_jax(model: PatchNet) -> dict:
    """The flax-layout tree of float32 numpy arrays of ``model``."""
    out = {}
    for name in _leaf_shapes():
        layer = getattr(model, name)
        w = layer.weight.detach().cpu()
        w = w.permute(2, 3, 1, 0) if w.ndim == 4 else w.T
        out[name] = {"kernel": np.ascontiguousarray(w.numpy()),
                     "bias": layer.bias.detach().cpu().numpy().copy()}
    return {"params": out}


def loss_fn(model: PatchNet, patches: torch.Tensor, labels: torch.Tensor):
    """(mean cross entropy of the float32 logits, mean accuracy of their
    argmax), both 0-d tensors."""
    logits = model(patches)
    loss = F.cross_entropy(logits, labels.long())
    acc = (torch.argmax(logits, -1) == labels).to(torch.float32).mean()
    return loss, acc


# ---------------------------------------------------------------------------
# Dataset harvesting (rendered boards with known labels).
# ---------------------------------------------------------------------------

def _harvest_specs(n_boards: int, frame_hw, seed: int) -> list:
    """Per board (labels (19, 19) int8, corners, ``synth.render_frame``'s
    keyword arguments, corners to warp through), from the reference's
    draws in its order."""
    from camkifu_tpu_torch.utils import synth

    rng = np.random.default_rng(seed)
    palettes = sorted(synth.PALETTES)
    specs = []
    for b in range(n_boards):
        labels = np.zeros((19, 19), np.int8)
        n = int(rng.integers(0, 300))
        if n:
            idx = rng.choice(361, n, replace=False)
            labels.flat[idx[::2]] = 1
            labels.flat[idx[1::2]] = 2
        persp = float(rng.uniform(0.03, 0.30))
        corners = synth.default_corners(frame_hw, perspective=persp)
        # Cycle wood palettes and sample the adversarial-eval degradation
        # ranges, so the voter is not tuned to one board look or to clean
        # studio frames.
        render_kw = dict(
            seed=int(rng.integers(1 << 30)),
            stone_jitter=0.06, palette=palettes[b % len(palettes)],
            light_gradient=float(rng.uniform(0.0, 0.35)),
            blur_sigma=float(rng.choice([0.0, 0.0, 0.8, 1.4])),
            shadow=float(rng.choice([0.0, 0.0, 0.15, 0.25])),
            wood_texture=float(rng.choice([0.0, 0.08, 0.12])),
            vignette=float(rng.choice([0.0, 0.0, 0.22])),
            glare=float(rng.choice([0.0, 0.0, 0.4, 0.6])),
            shot_noise=float(rng.choice([0.0, 0.0, 0.3, 0.5])))
        # Warp through PERTURBED corners (rotation up to ~1.2°, a few px
        # of shift): the runtime feeds the classifier canonicals with this
        # kind of residual, so train on it.
        wc = corners
        if rng.random() < 0.5:
            th = float(rng.normal(0.0, 0.012))
            ctr = corners.mean(axis=0)
            rot = np.array([[np.cos(th), -np.sin(th)],
                            [np.sin(th), np.cos(th)]], np.float32)
            wc = (ctr + (corners - ctr) @ rot.T
                  + rng.normal(0.0, 1.5, (1, 2))).astype(np.float32)
        specs.append((labels, corners, render_kw, wc))
    return specs


def harvest_patches(n_boards: int = 40, frame_hw=(720, 1280), seed: int = 0,
                    zone: int = cvconf.zone_size, device="cuda"):
    """Render boards with known labels → (patches (N, z, z, 3) float32 in
    [0, 1], labels (N,) int64), N = 361 · n_boards, on ``device``.

    Boards are rendered on the device and warped ``HARVEST_CHUNK`` a
    launch, each through its own homography."""
    from camkifu_tpu_torch.core.feeder import to_device
    from camkifu_tpu_torch.ops.warp import (canonical_corners,
                                            homography_dlt, warp_frames)
    from camkifu_tpu_torch.ops.zones import extract_zones
    from camkifu_tpu_torch.utils import synth

    specs = _harvest_specs(n_boards, frame_hw, seed)
    size = 19 * zone
    dev = torch.device(device)
    ideal = canonical_corners(19, zone, dev)
    all_patches = []
    for i in range(0, n_boards, HARVEST_CHUNK):
        chunk = specs[i:i + HARVEST_CHUNK]
        fb = torch.stack([synth.render_frame(s[0], s[1], frame_hw, device=dev,
                                             **s[2])[0] for s in chunk])
        wc = to_device(np.stack([s[3] for s in chunk]), dev)
        canon = warp_frames(fb, homography_dlt(ideal, wc), (size, size),
                            1.0 / 255.0)
        all_patches.append(extract_zones(canon, 19, zone)
                           .reshape(-1, zone, zone, 3))
    labels = np.concatenate([s[0].reshape(-1) for s in specs])
    return torch.cat(all_patches), to_device(labels.astype(np.int64), dev)


# ---------------------------------------------------------------------------
# Single-card training (multi-card dp + tp: not ported, ROADMAP item 8).
# ---------------------------------------------------------------------------

def make_optimizer(model: PatchNet, lr: float = 3e-3) -> torch.optim.AdamW:
    """``optax.adamw(lr)``: betas (0.9, 0.999), eps 1e-8 outside the square
    root, weight decay 1e-4 on every leaf, biases included (torch's own
    default decay is 1e-2)."""
    return torch.optim.AdamW(model.parameters(), lr=lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def train_step(model: PatchNet, opt: torch.optim.Optimizer,
               patches: torch.Tensor, labels: torch.Tensor):
    """One AdamW step on a batch → (loss, accuracy), 0-d tensors."""
    opt.zero_grad(set_to_none=True)
    loss, acc = loss_fn(model, patches, labels)
    loss.backward()
    opt.step()
    return loss.detach(), acc


def train(patches: torch.Tensor, labels: torch.Tensor, epochs: int = 3,
          batch: int = 2048, lr: float = 3e-3, seed: int = 0, log=None):
    """Train a PatchNet on ``patches``' device → (model, the last batch's
    accuracy). Each epoch visits the patches in numpy
    ``default_rng(seed)``'s permutation, the reference's order, and drops
    the last partial batch."""
    from camkifu_tpu_torch.core.feeder import to_device

    dev = patches.device
    model = init_params(torch.Generator().manual_seed(seed),
                        zone=patches.shape[1], device=dev)
    opt = make_optimizer(model, lr)
    n = len(patches)
    rng = np.random.default_rng(seed)
    loss = acc = torch.zeros(())
    for epoch in range(epochs):
        order = to_device(rng.permutation(n), dev)
        for i in range(0, n - batch + 1, batch):
            sel = order[i:i + batch]
            loss, acc = train_step(model, opt, patches[sel], labels[sel])
        if log:
            log(f"epoch {epoch}: loss {float(loss):.4f} acc {float(acc):.4f}")
    return model, float(acc)


# ---------------------------------------------------------------------------
# Checkpointing (.npz in the flax layout).
# ---------------------------------------------------------------------------

#: The checkpoint SfNeural and SfMeta read; ``~`` is the home directory at
#: the time of the call.
DEFAULT_CKPT = "~/.camkifu_tpu_torch/sf_neural.npz"


def save_params(model: PatchNet, path: str = DEFAULT_CKPT) -> None:
    """Write ``model`` to ``path`` as an ``.npz`` of flax-layout leaves
    (``params/Conv_0/kernel``, …), through a temporary file."""
    path = os.path.abspath(os.path.expanduser(path))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tree = params_to_jax(model)["params"]
    flat = {f"params/{layer}/{leaf}": a
            for layer, leaves in tree.items() for leaf, a in leaves.items()}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **flat)
    os.replace(tmp, path)


def load_params(path: str = DEFAULT_CKPT, device="cuda") -> PatchNet | None:
    """The trained classifier on ``device``, or None if no checkpoint
    exists. Leaves are read by name and checked against ``init_params``'
    shapes; a file with missing or extra leaves is refused.

    Only a user-trained checkpoint participates (no pretrained one ships:
    the reference's ablations found the classical ensemble saturating every
    measured configuration with and without the voter)."""
    path = os.path.abspath(os.path.expanduser(path))
    if not os.path.isfile(path):
        return None
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if len(parts) != 3 or parts[0] != "params":
                raise ValueError(f"{path}: leaf {key!r} is not "
                                 f"params/<layer>/<leaf>")
            tree.setdefault("params", {}).setdefault(parts[1], {})[
                parts[2]] = data[key]
    return params_from_jax(tree, device)


def main(argv=None, device="cuda") -> int:
    """cktrain on the port: harvest, train, save the checkpoint that
    SfNeural uses and SfMeta picks up as its third voter."""
    import argparse

    ap = argparse.ArgumentParser(prog="python -m camkifu_tpu_torch.models."
                                      "neural")
    ap.add_argument("--boards", type=int, default=48,
                    help="rendered boards to harvest patches from")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=0,
                    help="0 = auto (dataset/12, clamped to [256, 2048]) so "
                         "small harvests still get enough optimizer steps")
    ap.add_argument("--out", default=DEFAULT_CKPT)
    ap.add_argument("--sharded", action="store_true",
                    help="dp+tp training over several devices (not ported)")
    args = ap.parse_args(argv)
    if args.sharded:
        raise NotImplementedError(
            "--sharded (parallel/train.py: dp + tp over several cards) is "
            "ROADMAP Queue A item 8, not ported; train on one card")

    print(f"harvesting patches from {args.boards} boards…")
    patches, labels = harvest_patches(n_boards=args.boards, device=device)
    if not args.batch:
        args.batch = int(np.clip(len(patches) // 12, 256, 2048))
    print(f"{len(patches)} patches; training (batch {args.batch})…")
    model, acc = train(patches, labels, epochs=args.epochs,
                       batch=args.batch, log=print)
    save_params(model, args.out)
    print(f"accuracy {acc:.4f}; checkpoint saved to {args.out}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
