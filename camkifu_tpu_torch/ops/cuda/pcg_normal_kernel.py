"""The renderer's sensor noise on the card, drawn exactly as numpy draws it.

Replaces no Pallas kernel: the reference draws the noise on the host with
the frame's ``np.random.default_rng(seed)``
(``camkifu_tpu/utils/synth.py:322-332``): ``rng.normal(0, noise, shape)``
added in float64, or with shot noise ``rng.standard_normal(shape)`` cast to
float32 times ``sqrt(noise² + shot·f)``, then clipped and truncated to
uint8. That is PCG64's words through numpy's ziggurat normal sampler, a
deterministic algorithm: the CUDA source
``camkifu_tpu_torch/csrc/pcg_normal.cu`` computes the same numbers, bit for
bit, from the generator's 128-bit state and increment.

What bounds it on the card: operations, not bytes. The frame crosses
device memory once each way (2 bytes a value: 5.5 MB at 720p, 1.7 µs at
3.35 TB/s), but each word of the generator is a 128-bit multiply-add, 16
32-bit multiply-adds, and a normal takes ~1.022 words: ~45 M at 720p, ~2.7
µs at the card's INT32 rate. What makes it hard is that a normal takes a
varying number of words (1 on the fast path, 2 for a wedge test, and a
rejection starts again; 1 + 2m in the tail), so normal k's place in the
word stream depends on every earlier rejection. The design is one pass
with decoupled look-back: a block takes the next tile of 128 runs of 32
words from a counter in scratch, draws each word once into shared memory,
tables each run's chain of attempts from its first 4 words, composes the
tables over the block and publishes the tile's aggregate, looks back over
the tiles before it for its entry and first output, publishes its own
inclusive value, and writes the frame's span of its normals from the
buffered words (the source's header says more). The entry point zeroes
the counter and the published values on the caller's stream before its
one launch.

Contract (both versions): ``frame`` (H, W, 3) or any shape of uint8;
``state`` and ``inc`` the PCG64 state's two Python ints
(``rng.bit_generator.state["state"]``); ``noise`` and ``shot_noise`` Python
floats, not both zero. Returns a new uint8 tensor of the frame's shape on
its device: output k takes the k-th normal of the stream.
"""

from __future__ import annotations

import numpy as np
import torch

from camkifu_tpu_torch.ops.cuda import _build

#: Kernel launches since the last reset (one per call on a CUDA tensor).
launches = 0

_MASK64 = (1 << 64) - 1


def _check(frame: torch.Tensor, noise: float, shot_noise: float) -> None:
    if frame.dtype != torch.uint8:
        raise TypeError(f"the sensor noise takes uint8 frames, got "
                        f"{frame.dtype}")
    if not (noise or shot_noise):
        raise ValueError("noise and shot_noise are both zero: nothing to "
                         "draw")


def pcg_normal_noise(frame: torch.Tensor, state: int, inc: int,
                     noise: float, shot_noise: float = 0.0) -> torch.Tensor:
    """The CUDA kernel: ``frame`` a contiguous uint8 CUDA tensor."""
    global launches
    _check(frame, noise, shot_noise)
    if not frame.is_cuda:
        raise ValueError("pcg_normal_noise launches on CUDA tensors only; "
                         "use pcg_normal_noise_ref on the CPU")
    if not frame.is_contiguous():
        raise ValueError("pcg_normal_noise needs a contiguous frame")
    n = frame.numel()
    out = torch.empty_like(frame)
    if n == 0:
        return out
    if n > 0x7F000000:
        raise ValueError(f"pcg_normal_noise takes under 2^31 values, got "
                         f"{n}")
    lib = _build.lib()
    scratch = torch.empty(lib.camkifu_pcg_normal_scratch(n),
                          dtype=torch.int32, device=frame.device)
    shot = bool(shot_noise)
    with torch.cuda.device(frame.device):
        code = lib.camkifu_pcg_normal(
            frame.data_ptr(), out.data_ptr(), n,
            (state >> 64) & _MASK64, state & _MASK64,
            (inc >> 64) & _MASK64, inc & _MASK64,
            int(shot), float(noise), float(np.float32(noise * noise)),
            float(np.float32(shot_noise)), scratch.data_ptr(),
            _build.stream_handle(frame.device))
    _build.check(code, "pcg_normal")
    launches += 1
    return out


def generator(state: int, inc: int) -> np.random.Generator:
    """A fresh numpy Generator at PCG64 ``(state, inc)``."""
    g = np.random.Generator(np.random.PCG64())
    g.bit_generator.state = {"bit_generator": "PCG64",
                             "state": {"state": state, "inc": inc},
                             "has_uint32": 0, "uinteger": 0}
    return g


def pcg_normal_noise_ref(frame: torch.Tensor, state: int, inc: int,
                         noise: float, shot_noise: float = 0.0
                         ) -> torch.Tensor:
    """Plain version, on any device: numpy's own draw from ``(state,
    inc)``, the function the kernel reproduces, in the reference's
    expression (``camkifu_tpu/utils/synth.py:322-332``) on the host; the
    result goes back to the frame's device."""
    _check(frame, noise, shot_noise)
    rng, noise, shot_noise = generator(state, inc), float(noise), \
        float(shot_noise)
    f = frame.cpu().numpy().astype(np.float32)
    if shot_noise:
        std = np.sqrt(noise * noise + shot_noise * f)
        out = f + rng.standard_normal(f.shape).astype(np.float32) * std
    else:
        out = f + rng.normal(0, noise, f.shape)
    return torch.from_numpy(np.clip(out, 0, 255).astype(np.uint8)).to(
        frame.device)


def sensor_noise(frame: torch.Tensor, state: int, inc: int, noise: float,
                 shot_noise: float = 0.0) -> torch.Tensor:
    """The kernel on a CUDA tensor, the plain version on the CPU."""
    fn = pcg_normal_noise if frame.is_cuda else pcg_normal_noise_ref
    return fn(frame, state, inc, noise, shot_noise)
