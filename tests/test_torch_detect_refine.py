"""The port's detection refine stage against the JAX reference on the CPU:
the same uint8 gray, coarse quad and score (from the JAX stage 1) into both
``_detect_refine``s, on a line-dominated and a stone-saturated 720p board,
so each branch of the refine runs."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from camkifu_tpu.board import bf_auto as jbf
from camkifu_tpu.utils import synth
from camkifu_tpu_torch.board import bf_auto

torch.set_num_threads(1)


@functools.lru_cache(maxsize=1)
def _jax_stages():
    return (jax.jit(jbf._detect_prepare, static_argnums=1),
            jax.jit(jbf._detect_refine, static_argnums=(3, 4)))


@pytest.mark.parametrize("nstones,seed", [(40, 1), (250, 3)])
def test_detect_refine_matches_jax(nstones, seed):
    labels = np.zeros((19, 19), np.int8)
    idx = np.random.default_rng(seed).choice(361, nstones, replace=False)
    labels.flat[idx[::2]] = 1
    labels.flat[idx[1::2]] = 2
    frame, corners = synth.render_frame(labels, frame_hw=(720, 1280),
                                        seed=seed)
    prepare, refine = _jax_stages()
    gray, quad, score = prepare(jnp.asarray(frame), 256)
    ref = np.asarray(refine(gray, quad, score, 19, 1))
    ours = bf_auto._detect_refine(torch.from_numpy(np.array(gray)),
                                  torch.from_numpy(np.array(quad)),
                                  torch.tensor(float(score)), 19, 1)
    assert np.abs(ours.numpy() - ref).max() < 0.5
    assert np.abs(ours.numpy() - corners).max() < 11.0
