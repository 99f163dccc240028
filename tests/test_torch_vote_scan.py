"""The vote scan (``ops.cuda.vote_scan_kernel``) on the CPU.

``sf_meta.scan_streams`` against the reference's ``_scan_canonical`` with
both packages' classifier stages replaced by the same readings, so the two
scans see equal inputs: random labels and confidences with ties, the
neural voter's, agitations on both sides of the threshold, padded frames,
an uninitialised background, region trust crossing the promote threshold
inside a batch, at g = 9, 13 and 19. Then a tensor model of the CUDA
kernel's design (``csrc/vote_scan.cu``: every thread's own recurrences,
the region trust and pixel (0, 0)'s background run alike in every thread)
bitwise against the plain version, NaN inputs included; the wrapper's
refusals, its launch counter and its inputs left unwritten."""

import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import camkifu_tpu.models.neural as jneural
import camkifu_tpu.ops.zones as jzones
from camkifu_tpu.ops import background as jbackground
from camkifu_tpu.stone import sf_meta as jsf
from camkifu_tpu_torch.config import cvconf
from camkifu_tpu_torch.models import neural
from camkifu_tpu_torch.ops.cuda import vote_scan_kernel as vsk
from camkifu_tpu_torch.stone import sf_meta

torch.set_num_threads(1)

ZONE = 16
#: Agitations on both sides of the threshold, and on it.
AGITATIONS = np.array([0.0, 0.005, np.float32(cvconf.agitation_threshold),
                       0.0121, 0.05, 0.3], np.float32)


def _readings(rng, n, b, g, neural_voter, agree=0.7):
    """Every input the scan takes from the classifier stage, per stream:
    labels and confidences (ties between the voters, values on the cast
    threshold), the net's logits, calm flags, agitations, small luma."""
    s = g * ZONE // sf_meta.BG_FACTOR
    lc = rng.integers(0, 3, (n, b, g, g)).astype(np.int8)
    lk = np.where(rng.random((n, b, g, g)) < agree, lc,
                  rng.integers(0, 3, (n, b, g, g))).astype(np.int8)
    cc = rng.random((n, b, g, g)).astype(np.float32)
    ck = rng.random((n, b, g, g)).astype(np.float32)
    tie = rng.random((n, b, g, g)) < 0.1
    ck[tie] = cc[tie]
    cc[rng.random((n, b, g, g)) < 0.05] = cvconf.vote_min_conf
    logits = (2 * rng.standard_normal((n, b * g * g, 3))).astype(np.float32) \
        if neural_voter else None
    zc = (rng.random((n, b, g, g)) < 0.8).astype(np.float32)
    ag = rng.choice(AGITATIONS, (n, b)).astype(np.float32)
    luma = rng.random((n, b, s, s)).astype(np.float32)
    return dict(lc=lc, lk=lk, cc=cc, ck=ck, logits=logits, zc=zc, ag=ag,
                luma=luma)


def _state(rng, n, g, fresh, trust):
    s = g * ZONE // sf_meta.BG_FACTOR
    if fresh:
        votes = np.zeros((n, g, g, 3), np.float32)
        stable = np.zeros((n, g, g), np.int8)
        bg = np.full((n, s, s), -1.0, np.float32)
    else:
        votes = (6 * rng.random((n, g, g, 3))).astype(np.float32)
        stable = rng.integers(0, 3, (n, g, g)).astype(np.int8)
        bg = rng.random((n, s, s)).astype(np.float32)
    return dict(votes=votes, stable=stable, bg=bg, prev=bg.copy(),
                trust=np.full((n, 3, 3), trust, np.float32),
                frame_count=np.full((n,), 5, np.int32))


def _jax_scan(monkeypatch, r, st, k, g, valid_count):
    """Stream ``k`` through the reference's ``_scan_canonical``, its
    classifier stage stubbed to return ``r``'s readings: a canonical frame
    holds its index, which the stubs look up."""
    b = r["lc"].shape[1]
    luma = jnp.asarray(r["luma"][k])

    def frame(c):
        return c[0, 0, 0].astype(jnp.int32)

    def pick(name):
        return jnp.asarray(r[name][k])

    monkeypatch.setattr(jsf, "rgb_to_gray", lambda c: c[..., 0])
    monkeypatch.setattr(jsf, "background", types.SimpleNamespace(
        downsample_luma=lambda x, f: luma[x[0, 0].astype(jnp.int32)],
        update_background=jbackground.update_background))
    monkeypatch.setattr(jsf, "zone_stats", lambda c, gs, z: frame(c))
    monkeypatch.setattr(jsf, "sf_contours", types.SimpleNamespace(
        classify_stats=lambda i, z: (pick("lc")[i], pick("cc")[i])))
    monkeypatch.setattr(jsf, "sf_clustering", types.SimpleNamespace(
        classify_stats=lambda i: (pick("lk")[i], pick("ck")[i])))

    def gate(a, prev, gs):
        i = jnp.argmax(jnp.all(luma == a, axis=(1, 2)))
        return pick("zc")[i], pick("ag")[i]

    monkeypatch.setattr(jsf, "zone_motion_gate", gate)
    params = None
    if r["logits"] is not None:
        class Net:
            def apply(self, p, patches):
                return p

        monkeypatch.setattr(jneural, "PatchNet", Net)
        monkeypatch.setattr(jzones, "extract_zones", lambda c, gs, z:
                            jnp.zeros((gs * gs, z, z, 3), jnp.float32))
        params = jnp.asarray(r["logits"][k])
    state = jsf.MetaState(**{f: jnp.asarray(v[k]) for f, v in st.items()})
    canon = jnp.broadcast_to(jnp.arange(b, dtype=jnp.float32)
                             [:, None, None, None], (b, 2, 2, 3))
    return jsf._scan_canonical(state, canon, g, ZONE, params, valid_count)


def _net_probs(logits, b, g):
    """The net's softmax as the reference's ``_scan_canonical`` computes
    it from the logits: what the port's ``zone_probs`` stub returns."""
    probs = jax.nn.softmax(jnp.asarray(logits), axis=-1)
    return np.asarray(probs).reshape(b, g, g, 3)


def _port_scan(monkeypatch, r, st, g, valid_count):
    """``sf_meta.scan_streams`` over every stream, its classifier stage
    stubbed to ``r``'s readings."""
    n, b = r["lc"].shape[:2]
    flat = {k: torch.from_numpy(v.reshape(n * b, *v.shape[2:]))
            for k, v in r.items() if k not in ("logits", "zc", "ag")}

    def frame(x):
        return x[:, 0, 0, 0].long()

    monkeypatch.setattr(sf_meta, "rgb_to_gray", lambda c: c[..., 0])
    monkeypatch.setattr(sf_meta, "background", types.SimpleNamespace(
        downsample_luma=lambda x, f: flat["luma"][x[:, 0, 0].long()]))
    monkeypatch.setattr(sf_meta, "zone_stats", lambda c, gs, z: frame(c))
    monkeypatch.setattr(sf_meta, "sf_contours", types.SimpleNamespace(
        classify_stats=lambda i, z: (flat["lc"][i], flat["cc"][i])))
    monkeypatch.setattr(sf_meta, "sf_clustering", types.SimpleNamespace(
        classify_stats=lambda i: (flat["lk"][i], flat["ck"][i])))
    monkeypatch.setattr(sf_meta, "zone_motion_gate", lambda a, p, gs: (
        torch.from_numpy(r["zc"]), torch.from_numpy(r["ag"])))
    model = None
    if r["logits"] is not None:
        probs = torch.from_numpy(np.stack([
            _net_probs(r["logits"][k], b, g) for k in range(n)])
            .reshape(n * b, g, g, 3))
        monkeypatch.setattr(sf_meta, "zone_probs",
                            lambda m, c, gs, z: probs[frame(c)])
        model = neural.PatchNet()
    states = sf_meta.MetaState(**{f: torch.from_numpy(v.copy())
                                  for f, v in st.items()})
    canon = torch.arange(n * b, dtype=torch.float32).reshape(
        n, b, 1, 1, 1).expand(n, b, 2, 2, 3)
    return sf_meta.scan_streams(states, canon, g, ZONE, model, valid_count)


#: (g, frames, valid count, fresh state, starting trust, the net, agreement
#: of the two classifiers); "g9-padded" starts on TRUST_PROMOTE itself.
CASES = {
    "g19-fresh": (19, 16, None, True, 0.0, False, 0.7),
    "g9-padded": (9, 12, 7, False, 0.9, False, 0.7),
    "g13-neural": (13, 16, None, False, 0.95, True, 0.7),
    "g19-promote": (19, 16, 13, False, 0.86, False, 0.995),
}


@pytest.mark.parametrize("case", list(CASES))
def test_scan_streams_matches_reference_scan(monkeypatch, case):
    """Labels, the stable board and the frame count exactly; votes,
    background, trust and confidence within 1e-4 (the multi-stream
    tests' tolerance, ``_same_states``)."""
    g, b, valid_count, fresh, trust0, voter, agree = CASES[case]
    n = 2
    rng = np.random.default_rng(sum(map(ord, case)))
    r = _readings(rng, n, b, g, voter, agree)
    st = _state(rng, n, g, fresh, trust0)
    vsk.launches = 0
    got, labels, conf, agit = _port_scan(monkeypatch, r, st, g, valid_count)
    assert vsk.launches == 0
    if case == "g19-promote":
        # The trust crosses TRUST_PROMOTE inside the batch.
        assert float(got.trust.min()) > vsk.TRUST_PROMOTE > trust0
    for k in range(n):
        st_j, lab_j, conf_j, agit_j = _jax_scan(monkeypatch, r, st, k, g,
                                                valid_count)
        assert np.array_equal(labels[k].numpy(), np.asarray(lab_j))
        assert np.array_equal(agit[k].numpy(), np.asarray(agit_j))
        np.testing.assert_allclose(conf[k].numpy(), np.asarray(conf_j),
                                   rtol=0, atol=1e-4)
        assert np.array_equal(got.stable[k].numpy(), np.asarray(st_j.stable))
        assert int(got.frame_count[k]) == int(st_j.frame_count)
        for f in ("votes", "bg", "prev", "trust"):
            np.testing.assert_allclose(getattr(got, f)[k].numpy(),
                                       np.asarray(getattr(st_j, f)), rtol=0,
                                       atol=1e-4, err_msg=f)
    if fresh:
        assert float(got.bg.min()) >= 0.0


# -- the kernel's design in tensor ops -------------------------------------

def _beats(c, best):
    """The kernel's ``beats``: torch.argmax's order."""
    return ~torch.isnan(best) & (torch.isnan(c) | (c > best))


def _max_nan(a, b):
    return torch.where(torch.isnan(a) | (a > b), a, b)


def _middle(a, b, c):
    nans = torch.isnan(a).int() + torch.isnan(b).int() + torch.isnan(c).int()
    x = torch.where(torch.isnan(a), b, a)
    y = torch.where(torch.isnan(c), b, c)
    one = torch.where(x > y, x, y)
    lo = torch.where(a < b, a, b)
    hi = torch.where(a < b, b, a)
    m = torch.where(hi < c, hi, c)
    none = torch.where(lo > m, lo, m)
    return torch.where(nans >= 2, torch.nan, torch.where(nans == 1, one,
                                                         none))


def _clamp01(x):
    return torch.where(torch.isnan(x), x, x.clamp(0.0, 1.0))


def kernel_model(labs, confs, zone_calm, agitation, region_agree,
                 luma_small, carry, valid_count, per_window):
    """``csrc/vote_scan.cu`` as each thread computes it, the threads as
    tensor elements: an intersection's region trust from its own loads, a
    pixel's background beside pixel (0, 0)'s, the steps of the valid frames
    only. ``per_window`` is how the plain version on this device scales
    the top vote to a confidence."""
    c = vsk._consts()
    (thr, keep_t, rate_t, promote, decay, min_conf, vote_thr, _, ema,
     slow) = (torch.tensor(v, dtype=torch.float32) for v in c)
    votes, stable, bg, trust = (x.clone() for x in carry)
    n, b, g = labs[0].shape[:3]
    nv = min(max(valid_count, 0), b)
    region = vsk.regions(g, "cpu")[0]
    tr = trust.reshape(n, 9)[:, region].reshape(n, g, g)   # a thread's own
    tw = trust.reshape(n, 9).clone()                       # threads 0-8
    v0, v1, v2 = votes.unbind(-1)
    st = stable.clone()
    x = bg.reshape(n, -1).clone()
    x00 = x[:, :1].clone()
    labels = torch.empty((n, b, g, g), dtype=torch.int8)
    conf = torch.empty((n, b, g, g))
    for i in range(nv):
        calm = (agitation[:, i] <= thr)
        ra = region_agree[:, i].reshape(n, 9)
        tr = torch.where(calm[:, None, None],
                         tr * keep_t + ra[:, region].reshape(n, g, g) * rate_t,
                         tr)
        tw = torch.where(calm[:, None], tw * keep_t + ra * rate_t, tw)
        cbest = confs[0][:, i]
        lab = labs[0][:, i]
        ck = torch.where(tr >= promote, confs[1][:, i], -1.0)
        win = _beats(ck, cbest)
        cbest, lab = torch.where(win, ck, cbest), \
            torch.where(win, labs[1][:, i], lab)
        win = _beats(confs[2][:, i], cbest)
        cbest, lab = torch.where(win, confs[2][:, i], cbest), \
            torch.where(win, labs[2][:, i], lab)
        cast = torch.where(cbest >= min_conf, 1.0, 0.0)
        cm = zone_calm[:, i]
        ws = [(torch.where(lab == j, 1.0, 0.0) * cast) * cm for j in range(3)]
        v0, v1, v2 = v0 * decay + ws[0], v1 * decay + ws[1], \
            v2 * decay + ws[2]
        top = _max_nan(_max_nan(v0, v1), v2)
        top_label = torch.zeros_like(st)
        best = v0
        win = _beats(v1, best)
        best = torch.where(win, v1, best)
        top_label = torch.where(win, 1, top_label).to(torch.int8)
        top_label = torch.where(_beats(v2, best), 2, top_label) \
            .to(torch.int8)
        commit = (top >= vote_thr) & (top >= 2.0 * _middle(v0, v1, v2))
        st = torch.where(commit, top_label, st)
        labels[:, i], conf[:, i] = st, _clamp01(per_window(top))

        rate = torch.where(agitation[:, i] > thr, slow, ema)[:, None]
        keep = 1.0 - rate
        fresh = x00 < 0.0
        l00 = luma_small[:, i].reshape(n, -1)[:, :1]
        lu = luma_small[:, i].reshape(n, -1)
        x00 = torch.where(fresh, l00, x00) * keep + l00 * rate
        x = torch.where(fresh, lu, x) * keep + lu * rate
    old = _clamp01(per_window(_max_nan(_max_nan(v0, v1), v2)))
    labels[:, nv:] = st[:, None]
    conf[:, nv:] = old[:, None]
    return labels, conf, (torch.stack([v0, v1, v2], -1), st,
                          x.reshape(bg.shape), tw.reshape(n, 3, 3))


def _torch_inputs(r, st):
    labs = tuple(torch.from_numpy(r[k]) for k in ("lc", "lk", "lc"))
    n, b, g = r["lc"].shape[:3]
    agree = (labs[0] == labs[1]).float().reshape(n, b, -1)
    region, counts = vsk.regions(g, "cpu")
    ragree = (torch.zeros((n, b, 9)).index_add_(2, region, agree) / counts) \
        .reshape(n, b, 3, 3)
    confs = (torch.from_numpy(r["cc"]), torch.from_numpy(r["ck"]),
             torch.from_numpy(r["cc"][:, ::-1].copy()))
    carry = tuple(torch.from_numpy(st[k].copy())
                  for k in ("votes", "stable", "bg", "trust"))
    return labs, confs, torch.from_numpy(r["zc"]), torch.from_numpy(r["ag"]), \
        ragree, torch.from_numpy(r["luma"]), carry


@pytest.mark.parametrize("g,b,valid_count,fresh,nans", [
    (19, 16, 16, True, False), (13, 20, 11, False, False),
    (9, 8, 0, False, False), (19, 9, 9, False, True)])
def test_kernel_design_equals_plain(g, b, valid_count, fresh, nans):
    """The kernel's per-thread arithmetic, bitwise the plain version on
    the CPU (where the plain version divides by the vote window)."""
    rng = np.random.default_rng(g * 100 + b)
    r = _readings(rng, 3, b, g, False)
    st = _state(rng, 3, g, fresh, 0.88)
    if nans:
        for key in ("cc", "ck", "ag", "zc", "luma"):
            a = r[key].reshape(-1)
            a[rng.choice(a.size, max(1, a.size // 50), replace=False)] = np.nan
        st["votes"].reshape(-1)[::97] = np.nan
        st["bg"][1, 0, 0] = np.nan
    args = _torch_inputs(r, st)
    want = vsk.vote_scan_ref(*args, valid_count)
    got = kernel_model(*args, valid_count,
                       per_window=lambda t: t / cvconf.vote_window)
    assert torch.equal(got[0], want[0])
    assert torch.allclose(got[1], want[1], rtol=0, atol=0, equal_nan=True)
    for a, w in zip(got[2], want[2]):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.allclose(a.double(), w.double(), rtol=0, atol=0,
                              equal_nan=True)
    if nans:
        assert bool(torch.isnan(want[1]).any())


def test_vote_scan_refuses_and_counts(monkeypatch):
    """Wrong dtype, shape or device raise; the CPU runs the plain version
    without a launch and writes no input."""
    rng = np.random.default_rng(7)
    r = _readings(rng, 2, 6, 9, False)
    st = _state(rng, 2, 9, False, 0.5)
    labs, confs, zc, ag, ragree, luma, carry = _torch_inputs(r, st)
    kept = [x.clone() for x in (*labs, *confs, zc, ag, ragree, luma, *carry)]
    vsk.launches = 0
    out = vsk.vote_scan(labs, confs, zc, ag, ragree, luma, carry, 4)
    assert vsk.launches == 0
    for a, b in zip(kept, (*labs, *confs, zc, ag, ragree, luma, *carry)):
        assert torch.equal(a, b)
    for a in (*out[:2], *out[2]):
        assert all(a.data_ptr() != x.data_ptr() for x in kept + list(carry))
    with pytest.raises(TypeError):
        vsk.vote_scan(labs, (confs[0].double(), *confs[1:]), zc, ag, ragree,
                      luma, carry, 4)
    with pytest.raises(ValueError):
        vsk.vote_scan(labs, confs, zc[:, :5], ag, ragree, luma, carry, 4)
    with pytest.raises(ValueError):
        vsk.vote_scan(labs, confs, zc, ag, ragree, luma[..., :-1], carry, 4)
    with pytest.raises(ValueError):
        vsk.vote_scan(labs, confs, zc, ag.to("meta"), ragree, luma, carry,
                      4)
    meta = tuple(x.to("meta") for x in (zc, ag, ragree, luma))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        vsk.vote_scan(tuple(x.to("meta") for x in labs),
                      tuple(x.to("meta") for x in confs), *meta,
                      tuple(x.to("meta") for x in carry), 4)


def test_scan_streams_hands_the_scan_contiguous_inputs(monkeypatch):
    """One ``vote_scan`` call a ``scan_streams`` call, every tensor it
    hands over contiguous (the kernel refuses others), on a state whose
    fields are views of a wider one."""
    calls = []
    real = sf_meta.vote_scan

    def spy(labs, confs, *rest):
        tensors = [*labs, *confs, *rest[:4], *rest[4]]
        calls.append(all(x.is_contiguous() for x in tensors))
        return real(labs, confs, *rest)

    monkeypatch.setattr(sf_meta, "vote_scan", spy)
    g, n, b = 9, 2, 4
    wide = sf_meta.MetaState(*(x[None].expand(2 * n, *x.shape).clone()
                               for x in sf_meta.init_state(g, ZONE, "cpu")))
    states = sf_meta.MetaState(*(x[::2] for x in wide))
    assert not states.votes.is_contiguous()
    canon = torch.rand((n, b, g * ZONE, g * ZONE, 3),
                       generator=torch.Generator().manual_seed(3))
    sf_meta.scan_streams(states, canon, g, ZONE)
    assert calls == [True]
