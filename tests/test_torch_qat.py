"""The port's QAT modules against the JAX package, on the CPU.

Modules: ``core/quantizers`` (the straight-through gradient, entry for
entry: 0.5 at exactly +-qmax as ``jnp.clip`` gives), ``core/codebook``
(the octahedral codebook, ``quantize_direction``, ``covering_radius``),
``core/attention_norm``, ``core/lee`` (the differentiable regularizer
under JAX's rotations), ``core/ste`` under nested differentiation, and
``models/so3krates``'s QAT ``energy``/``forces`` in all five ``quant``
modes and with ``freeze_vec_quant``. The same numpy inputs and the JAX
package's weights (through ``weights.params_from_numpy``) go through
both packages.

Tolerances: energies and forces to 1e-5 of the largest |value| in fp32
and 1e-4 in the quantized modes. A quantized case that misses its
tolerance must come with a moved site (:func:`moved_sites`): a weight,
A8 or vector code, or the clip's gate at an abs-max entry (x / scale
lands on qmax, one ulp under it or one over it, which gives gradient
0.5, 1 or 0), or an MDDQ code that differs between the packages on the
same inputs; the test prints the moved sites and fails without one.
Then the port runs again with the JAX package's values pinned at every
site (:func:`port_sites`), and that run must hold the tolerance. The JAX
references are jitted, as the JAX trainer runs them, and their sites
are recorded from inside the same program (:func:`jax_recorded_sites`):
jitted XLA rounds some x / scale an ulp off eager JAX and the port, so
every quantized mode moves a few gates at these seeds.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers.equivariance import (assert_energy_rotation_invariant,
                                  assert_energy_translation_invariant,
                                  assert_permutation_equivariant,
                                  assert_rotation_equivariant, rotation)
from repro.core import attention_norm as jan
from repro.core import codebook as jcb
from repro.core import lee_regularizer as j_lee_regularizer
from repro.core import random_rotations as j_random_rotations
from repro.core import mddq as jmddq
from repro.core import quantizers as jq
from repro.data.synthetic_md import sample_dataset as j_sample_dataset
from repro.models import so3krates as jso3
from repro_torch.core import attention_norm as tan
from repro_torch.core import codebook as tcb
from repro_torch.core import lee as tlee
from repro_torch.core import mddq as tmddq
from repro_torch.core import quantizers as tq
from repro_torch.core.ste import round_ste
from repro_torch.models import so3krates as tso3
from repro_torch.weights import params_from_numpy

CFG_KW = dict(feat=16, vec_feat=4, n_layers=2, n_rbf=8, dir_bits=8)
BASELINE = dict(robust_attention=False)
MODES = [("none", {}), ("gaq_w4a8", {}),
         ("gaq_w4a8", dict(freeze_vec_quant=True)),
         ("naive_int8", BASELINE), ("degree_quant", BASELINE),
         ("svq_kmeans", BASELINE)]
MODE_IDS = ["fp32", "gaq_w4a8", "gaq_w4a8_frozen", "naive_int8",
            "degree_quant", "svq_kmeans"]
FP32_REL, QUANT_REL = 1e-5, 1e-4


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _t(a):
    return torch.from_numpy(np.array(a))


def cfgs(quant, extra, **kw):
    kw = {**CFG_KW, **kw, **extra}
    return (jso3.So3kratesConfig(quant=quant, **kw),
            tso3.So3kratesConfig(quant=quant, **kw))


# --- where a quantized gap comes from -----------------------------------------

def _w_bits(cfg, branch):
    """The weight bits ``_qw`` takes (both packages)."""
    if cfg.quant in ("naive_int8", "degree_quant", "svq_kmeans"):
        return 8
    return cfg.w_bits if branch == "eqv" else cfg.w_bits_inv


def _a8_signature(y, qmax=127):
    """(code, gate) of x / scale: the rounded clipped value, and the clip's
    gradient (1 inside, 0.5 exactly on +-qmax, 0 beyond)."""
    y = np.asarray(y)
    a = np.abs(y)
    gate = np.where(a < qmax, 1.0, np.where(a == qmax, 0.5, 0.0))
    return np.round(np.clip(y, -qmax, qmax)), gate


@contextlib.contextmanager
def port_sites(pin=None):
    """Record every quantization site of the port's QAT model inside the
    block, in call order: ("q127", x / scale) for A8 activations and the
    baselines' INT8 vectors, ("w<qmax>", w / scale) for the W4/W8
    weights, ("code", codes) for MDDQ and SVQ. With
    ``pin`` (sites in the same order, e.g. the JAX package's) each site
    takes the pinned value of x / scale or the pinned codes instead of
    its own, gradients as before: what is left of a gap is then not a
    moved code or gate."""
    rec = []
    pins = iter(pin or ())
    qw, qact, qvec = tso3._qw, tso3._qact, tso3._qvec

    def a8(x, scale, bits, nested, kind="q"):
        m = tq.qmax(bits)
        y = x / scale
        rec.append((f"{kind}{m}", _np(y)))
        if pin is None:
            return None
        y = y + (_t(next(pins)[1]) - y).detach()
        return round_ste(tq.clip(y, -m, m), nested) * scale

    def rec_w(w, cfg, branch):
        if cfg.quant != "none":
            bits = _w_bits(cfg, branch)
            out = a8(w, tq.abs_max_scale(w.detach(), bits, w.ndim - 1), bits,
                     False, "w")
            if out is not None:
                return out
        return qw(w, cfg, branch)

    def rec_act(x, cfg, degrees=None, nested=False):
        if cfg.quant != "none":
            out = a8(x, tso3._act_scale(x, cfg, degrees), cfg.a_bits, nested)
            if out is not None:
                return out
        return qact(x, cfg, degrees, nested)

    def rec_vec(v, cfg, codebook, nested=False):
        d = v.detach()
        if cfg.quant == "none" or cfg.freeze_vec_quant:
            pass
        elif cfg.quant == "gaq_w4a8":
            mc = cfg.mddq()
            rec.extend(("code", _np(c))
                       for c in tmddq.mddq_encode(d, mc, codebook))
            if pin is not None:
                idx, mag = (_t(next(pins)[1]).long() for _ in range(2))
                m_q = tq.dequantize_log_magnitude(mag, mc.magnitude_bits,
                                                  mc.m_min, mc.m_max)
                return tmddq.fake_quant_from_codes(
                    v, mc, codebook[idx], m_q[..., None], nested)
        elif cfg.quant == "svq_kmeans":
            m = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
            rec.append(("code", _np(tcb.nearest_code(
                d / torch.clamp(m, min=1e-12), codebook))))
            if pin is not None:
                return codebook[_t(next(pins)[1]).long()] * m
        else:
            out = a8(v, tso3._mol_scale(d, 8, 3), 8, nested)
            if out is not None:
                return out
        return qvec(v, cfg, codebook, nested)
    tso3._qw, tso3._qact, tso3._qvec = rec_w, rec_act, rec_vec
    try:
        yield rec
    finally:
        tso3._qw, tso3._qact, tso3._qvec = qw, qact, qvec


@contextlib.contextmanager
def jax_recorded_sites():
    """While active, the JAX package's QAT model reports every
    quantization site of every energy it runs from inside the program
    (jitted, vmapped, differentiated), by ``jax.debug.callback``, so the
    values are the ones that program used. Yields a list that the run
    fills with (group, site, kind, coords, value): ``group`` numbers the
    traced energy calls in trace order (a loss: the batch, then the LEE
    term's rotated and given molecule), ``site`` the sites within one,
    ``coords`` the molecule's coordinates (vmap calls back per molecule);
    kinds as :func:`port_sites`. :func:`assemble` orders them."""
    calls = []
    trace = {"group": -1, "site": 0, "coords": None}
    energy, qw, qact, qvec = jso3.energy, jso3._qw, jso3._qact, jso3._qvec

    def emit(kind, value):
        key = (trace["group"], trace["site"], kind)
        trace["site"] += 1
        jax.debug.callback(lambda c, v: calls.append(
            key + (np.array(c), np.array(v))), trace["coords"], value)

    def rec_energy(params, cfg, species, coords, codebook=None):
        trace.update(group=trace["group"] + 1, site=0, coords=coords)
        return energy(params, cfg, species, coords, codebook)

    def rec_w(w, cfg, branch):
        if cfg.quant != "none":
            bits = _w_bits(cfg, branch)
            emit(f"w{jq.qmax(bits)}", w / jq.abs_max_scale(
                jax.lax.stop_gradient(w), bits, w.ndim - 1))
        return qw(w, cfg, branch)

    def rec_act(x, cfg, degrees=None):
        if cfg.quant != "none":
            s = jq.abs_max_scale(jax.lax.stop_gradient(x), cfg.a_bits)
            if cfg.quant == "degree_quant" and degrees is not None:
                s = jnp.maximum(s * jnp.sqrt(degrees / jnp.maximum(
                    degrees.max(), 1.0))[:, None], 1e-8)
            emit("q127", x / s)
        return qact(x, cfg, degrees)

    def rec_vec(v, cfg, cb):
        if cfg.quant == "none" or cfg.freeze_vec_quant:
            pass
        elif cfg.quant == "gaq_w4a8":
            for a in jmddq.mddq_encode(v, cfg.mddq(), cb):
                emit("code", a)
        elif cfg.quant == "svq_kmeans":
            m = jnp.linalg.norm(v, axis=-1, keepdims=True)
            emit("code", jcb.nearest_code(v / jnp.maximum(m, 1e-12), cb))
        else:
            emit("q127", v / jq.abs_max_scale(v, 8))
        return qvec(v, cfg, cb)
    jso3.energy, jso3._qw, jso3._qact, jso3._qvec = (rec_energy, rec_w,
                                                     rec_act, rec_vec)
    try:
        yield calls
    finally:
        jso3.energy, jso3._qw, jso3._qact, jso3._qvec = energy, qw, qact, qvec


def assemble(calls, group, molecules):
    """One group's sites in site order: weights once, every other site
    stacked over ``molecules`` (each call matched to its molecule by its
    coordinates; equal molecules in arrival order)."""
    sites = {}
    for g, site, kind, c, v in calls:
        if g == group:
            got = sites.setdefault((site, kind), {})
            near = np.argsort([np.abs(c - m).max() for m in molecules],
                              kind="stable")
            got[next((int(i) for i in near if int(i) not in got),
                     int(near[0]))] = v
    out = []
    for (site, kind), vals in sorted(sites.items()):
        if len(vals) == 1:      # computed once for all (vmap left it unbatched)
            vals = dict.fromkeys(range(len(molecules)), vals[min(vals)])
        assert len(vals) == len(molecules), (site, kind, sorted(vals))
        out.append((kind, vals[0] if kind[0] == "w" else
                    np.stack([vals[i] for i in range(len(molecules))])))
    return out


def moved_sites(j_sites, p_sites):
    """Per site, the entries whose code or clip gate (weights, A8, INT8
    vectors) or code (MDDQ, SVQ) differ between the packages."""
    assert [k for k, _ in j_sites] == [k for k, _ in p_sites]
    moved = []
    for (kind, a), (_, b) in zip(j_sites, p_sites):
        if kind != "code":
            qmax = int(kind[1:])
            (ca, ga), (cb_, gb) = (_a8_signature(a, qmax),
                                   _a8_signature(b, qmax))
            moved.append(int(((ca != cb_) | (ga != gb)).sum()))
        else:
            moved.append(int((a != b).sum()))
    return moved


# --- module fixture: the JAX references, computed once --------------------------

@pytest.fixture(scope="module")
def setup():
    data = jax.jit(j_sample_dataset, static_argnums=1)(
        jax.random.PRNGKey(0), 4)
    jp = jax.jit(jso3.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jso3.So3kratesConfig(**CFG_KW))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    coords = np.asarray(data["coords"], np.float32)
    species = np.asarray(data["species"])
    refs = {}
    for mode_id, (quant, extra) in zip(MODE_IDS, MODES):
        jc, _ = cfgs(quant, extra)
        # jitted and vmapped over the molecules, as the JAX trainer runs
        # it, with its quantization sites recorded from inside
        with jax_recorded_sites() as calls:
            e, f = jax.jit(jax.vmap(lambda c: jso3.energy_and_forces(
                jp, jc, jnp.asarray(species), c)))(jnp.asarray(coords))
            e, f = np.asarray(e), np.asarray(f)
        refs[mode_id] = (e, f, assemble(calls, 0, coords))
    return dict(jp=jp, tp=tp, coords=coords, species=species, refs=refs)


# --- 1. quantizers ------------------------------------------------------------

class TestQuantizers:
    def test_fake_quant_ste_gradient_equals_jax_entry_for_entry(self):
        """200 random float32 vectors of 37 entries at 8 bits: the abs-max
        entry lands on qmax, where ``jnp.clip`` passes 0.5. (Eager: under
        ``jax.jit`` XLA divides by the scale with a reciprocal multiply, and
        the abs-max entry lands an ulp over qmax instead.)"""
        rng = np.random.default_rng(0)
        jgrad = jax.grad(lambda a: jnp.sum(jq.fake_quant_ste(a, 8)))
        on_qmax = 0
        for _ in range(200):
            x = rng.normal(size=37).astype(np.float32)
            xt = _t(x).requires_grad_()
            tq.fake_quant_ste(xt, 8).sum().backward()
            gj = np.asarray(jgrad(jnp.asarray(x)))
            np.testing.assert_array_equal(_np(xt.grad), gj)
            on_qmax += int((gj == 0.5).sum())
        assert on_qmax > 100        # the tie is common, not a corner case

    def test_saturated_entries_get_no_gradient(self):
        x = _t(np.array([-3.0, -1.0, 0.2, 1.0, 3.0], np.float32))
        x.requires_grad_()
        tq.fake_quant_ste(x, 8, scale=torch.tensor(1 / 127)).sum().backward()
        np.testing.assert_array_equal(_np(x.grad), [0, 0.5, 1, 0.5, 0])

    def test_config_dequantize_fake_quant(self):
        assert tq.QuantConfig(bits=4).levels == jq.QuantConfig(bits=4).levels
        assert dataclasses.asdict(tq.QuantConfig()) \
            == dataclasses.asdict(jq.QuantConfig())
        x = np.random.default_rng(1).normal(size=(9, 12)).astype(np.float32)
        for bits, axis in ((8, None), (4, 1)):
            js = jq.abs_max_scale(jnp.asarray(x), bits, axis)
            ts = tq.abs_max_scale(_t(x), bits, axis)
            np.testing.assert_array_equal(
                _np(tq.fake_quant(_t(x), ts, bits)),
                np.asarray(jq.fake_quant(jnp.asarray(x), js, bits)))
            q = tq.quantize(_t(x), ts, bits)
            np.testing.assert_array_equal(
                _np(tq.dequantize(q, ts)),
                np.asarray(jq.dequantize(jnp.asarray(_np(q)), js)))


# --- 2. codebooks -------------------------------------------------------------

class TestCodebook:
    @pytest.mark.parametrize("n", [24, 256, 4096])
    def test_octahedral_bit_identical_and_closed(self, n):
        c = tcb.octahedral_sphere(n)
        np.testing.assert_array_equal(c, jcb.octahedral_sphere(n))
        R = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
        d = np.linalg.norm((c @ R.T)[:, None] - c[None], axis=-1).min(1)
        assert d.max() < 1e-4
        np.testing.assert_array_equal(tcb._octahedral_rotations(),
                                      jcb._octahedral_rotations())

    def test_make_codebook_octahedral_is_not_z_sorted(self):
        cb = tcb.make_codebook(8, "octahedral")
        np.testing.assert_array_equal(
            _np(cb), np.asarray(jcb.make_codebook(8, "octahedral")))
        assert not cb.z_sorted and tcb.make_codebook(8).z_sorted
        with pytest.raises(ValueError):
            tcb.make_codebook(8, "icosahedral")

    @pytest.mark.parametrize("bits,kind", [(6, "fibonacci"),
                                           (8, "octahedral")])
    def test_quantize_direction(self, bits, kind):
        cb = tcb.make_codebook(bits, kind)
        v = np.random.default_rng(bits).normal(size=(500, 3))
        u = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)
        jd = jcb.quantize_direction(jnp.asarray(u), jnp.asarray(_np(cb)))
        np.testing.assert_array_equal(_np(tcb.quantize_direction(_t(u), cb)),
                                      np.asarray(jd))

    def test_covering_radius(self):
        """Held to the JAX package's on its own draw, and as
        ``tests/test_core_mddq.py`` holds it."""
        samples = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                               (20000, 3)))
        for bits in (4, 8):
            j = jcb.covering_radius(jcb.make_codebook(bits), n_samples=20000)
            t = tcb.covering_radius(tcb.make_codebook(bits), samples=samples)
            assert abs(t - j) < 1e-5, (bits, t, j)
        r4 = tcb.covering_radius(tcb.make_codebook(4), n_samples=20000)
        r8 = tcb.covering_radius(tcb.make_codebook(8), n_samples=20000)
        assert r8 < r4 and r8 < 0.25


# --- 3. attention ---------------------------------------------------------------

def test_cosine_attention_and_robust_weights():
    rng = np.random.default_rng(2)
    q, k = (rng.normal(size=(2, 7, 16)).astype(np.float32) for _ in "qk")
    bias = rng.normal(size=(2, 7, 7)).astype(np.float32)
    mask = rng.random((2, 7, 7)) > 0.3
    mask[..., 0] = True
    for b in (None, bias):
        jb = None if b is None else jnp.asarray(b)
        tb = None if b is None else _t(b)
        np.testing.assert_allclose(
            _np(tan.cosine_attention_logits(_t(q), _t(k), 5.0, tb)),
            np.asarray(jan.cosine_attention_logits(jnp.asarray(q),
                                                   jnp.asarray(k), 5.0, jb)),
            rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        _np(tan.robust_attention_weights(_t(q), _t(k), 10.0, _t(bias),
                                         _t(mask))),
        np.asarray(jan.robust_attention_weights(
            jnp.asarray(q), jnp.asarray(k), 10.0, jnp.asarray(bias),
            jnp.asarray(mask))), atol=1e-6)


# --- 4. LEE -------------------------------------------------------------------

class TestLEE:
    def test_random_rotation_is_a_rotation(self):
        R = tlee.random_rotation(np.random.default_rng(3))
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
        assert abs(np.linalg.det(R) - 1) < 1e-5
        np.testing.assert_array_equal(tlee.random_rotation(7),
                                      tlee.random_rotations(7, 1)[0])

    def test_regularizer_and_its_gradient_under_jax_rotations(self):
        """A force model that is not equivariant: the value and the
        gradient in its weights as the JAX package's, on the rotations
        its key draws."""
        rng = np.random.default_rng(4)
        coords = rng.normal(size=(6, 3)).astype(np.float32)
        w = rng.normal(size=(3, 3)).astype(np.float32)
        key = jax.random.PRNGKey(9)

        def j_loss(w_):
            return j_lee_regularizer(lambda c: jnp.tanh(c @ w_),
                                     jnp.asarray(coords), key, 3)
        jv, jg = jax.value_and_grad(j_loss)(jnp.asarray(w))
        rots = np.asarray(j_random_rotations(key, 3))
        wt = _t(w).requires_grad_()
        tv = tlee.lee_regularizer(lambda c: torch.tanh(c @ wt), _t(coords),
                                  rotations=rots)
        (tg,) = torch.autograd.grad(tv, wt)
        np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
        np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-4,
                                   atol=1e-6)
        # the port's own draw: a numpy seed or generator
        a = tlee.lee_regularizer(lambda c: torch.tanh(c @ wt), _t(coords),
                                 seed=5, n_rotations=3)
        b = tlee.lee_regularizer(lambda c: torch.tanh(c @ wt), _t(coords),
                                 rotations=tlee.random_rotations(5, 3))
        assert float(a) == float(b) > 0


# --- 5. the straight-through estimators under nested differentiation ------------

@pytest.mark.parametrize("kind", ["fake_quant", "mddq_geometric",
                                  "mddq_identity"])
def test_nested_ste_matches_jax(kind):
    """d/dp of a loss on d/dc f(c * p): JAX applies an estimator's rule in
    the inner derivative only, and differentiates its forward in the outer
    one (zero through the rounding and the codeword; the geometric STE's
    saved direction still carries gradient)."""
    rng = np.random.default_rng(5)
    c0 = rng.normal(size=(8, 3)).astype(np.float32)
    p0 = rng.normal(size=(3,)).astype(np.float32) + 1.5
    if kind == "fake_quant":
        s = np.float32(0.05)

        def jf(x):
            return jq.fake_quant_ste(x, 8, scale=s)

        def tf(x, nested):
            return tq.fake_quant_ste(x, 8, scale=torch.tensor(s),
                                     nested=nested)
    else:
        geo = kind == "mddq_geometric"
        jm = jmddq.MDDQConfig(direction_bits=6, geometric_ste=geo)
        tm = tmddq.MDDQConfig(direction_bits=6, geometric_ste=geo)

        def jf(x):
            return jmddq.mddq_fake_quant(x, jm)

        def tf(x, nested):
            return tmddq.mddq_fake_quant(x, tm, nested=nested)

    def j_loss(p):
        g = jax.grad(lambda c: jnp.sum(jf(c * p) ** 2 * c))(jnp.asarray(c0))
        return jnp.sum(g ** 2) + jnp.sum(jf(jnp.asarray(c0) * p))

    jg = np.asarray(jax.grad(j_loss)(jnp.asarray(p0)))
    p = _t(p0).requires_grad_()
    c = _t(c0).requires_grad_()
    (g,) = torch.autograd.grad((tf(c * p, True) ** 2 * c).sum(), c,
                               create_graph=True)
    # the second term takes no inner derivative: first-order estimators
    loss = (g ** 2).sum() + tf(_t(c0) * p, False).sum()
    (tg,) = torch.autograd.grad(loss, p)
    np.testing.assert_allclose(_np(tg), jg, rtol=1e-4, atol=1e-5)
    # the inner (recording) derivative of a nested estimator is the
    # first-order one
    x = _t(c0 * p0).requires_grad_()
    (g1,) = torch.autograd.grad(tf(x, False).sum(), x)
    (g2,) = torch.autograd.grad(tf(x, True).sum(), x, create_graph=True)
    np.testing.assert_array_equal(_np(g1), _np(g2))


# --- 6. the QAT model ---------------------------------------------------------------

@pytest.mark.parametrize("mode_id", MODE_IDS)
def test_energy_and_forces_match_jax(setup, mode_id):
    quant, extra = dict(zip(MODE_IDS, MODES))[mode_id]
    jc, tc = cfgs(quant, extra)
    je, jf, j_sites = setup["refs"][mode_id]
    with port_sites() as p_sites:
        te, tf = tso3.energy_and_forces(setup["tp"], tc, setup["species"],
                                        _t(setup["coords"]))
    assert te.shape == (4,) and tf.shape == (4, 24, 3)
    rel_e = float(np.abs(_np(te) - je).max() / np.abs(je).max())
    rel_f = float(np.abs(_np(tf) - jf).max() / np.abs(jf).max())
    tol = FP32_REL if quant == "none" else QUANT_REL
    if max(rel_e, rel_f) > tol:
        moved = moved_sites(j_sites, p_sites)
        print(f"{mode_id}: energy {rel_e:.3g}, forces {rel_f:.3g}; moved "
              f"codes or gates per site {moved}")
        assert quant != "none" and sum(moved) > 0, (rel_e, rel_f, moved)
        # the JAX package's codes and gates pinned: within the tolerance
        with port_sites(pin=j_sites):
            pe, pf = tso3.energy_and_forces(setup["tp"], tc,
                                            setup["species"],
                                            _t(setup["coords"]))
        assert np.abs(_np(pe) - je).max() <= tol * np.abs(je).max()
        assert np.abs(_np(pf) - jf).max() <= tol * np.abs(jf).max()


def test_single_molecule_equals_its_batch_row(setup):
    """Scales are per molecule: a molecule alone equals its batch row."""
    jc, tc = cfgs("naive_int8", BASELINE)
    e, f = tso3.energy_and_forces(setup["tp"], tc, setup["species"],
                                  _t(setup["coords"]))
    e1, f1 = tso3.energy_and_forces(setup["tp"], tc, setup["species"],
                                    _t(setup["coords"][2]))
    assert e1.shape == () and f1.shape == (24, 3)
    np.testing.assert_allclose(float(e1), float(e[2]), rtol=1e-6)
    np.testing.assert_allclose(_np(f1), _np(f[2]), rtol=1e-5, atol=1e-5)


def test_quantized_forward_uses_batched_species(setup):
    _, tc = cfgs("degree_quant", BASELINE)
    sp = np.broadcast_to(setup["species"], (4, 24))
    a = tso3.energy(setup["tp"], tc, sp, _t(setup["coords"]))
    b = tso3.energy(setup["tp"], tc, setup["species"], _t(setup["coords"]))
    np.testing.assert_array_equal(_np(a), _np(b))


# --- the JAX twins of tests/test_so3_system.py ------------------------------------

class TestSystem:
    @pytest.fixture
    def fp32(self, setup):
        _, tc = cfgs("none", {})
        sp, tp = setup["species"], setup["tp"]

        def energy(c):
            return float(tso3.energy(tp, tc, sp, _t(np.asarray(c,
                                                               np.float32))))

        def forces(c, species=sp):
            return _np(tso3.forces(tp, tc, np.asarray(species),
                                   _t(np.asarray(c, np.float32))))
        return energy, forces, setup["coords"][0]

    def test_fp32_energy_invariant(self, fp32):
        energy, _, c = fp32
        assert_energy_rotation_invariant(energy, c, seed=2)

    def test_fp32_forces_equivariant(self, fp32):
        _, forces, c = fp32
        assert_rotation_equivariant(lambda x, _R: (None, forces(x)), c,
                                    seed=3, atol=1e-4)

    def test_translation_invariance(self, fp32):
        energy, _, c = fp32
        assert_energy_translation_invariant(energy, c)

    def test_permutation_equivariance(self, fp32, setup):
        _, forces, c = fp32
        assert_permutation_equivariant(lambda sp, x: forces(x, sp),
                                       setup["species"], c)

    def test_forces_are_gradient_field(self, fp32):
        energy, forces, c = fp32
        f = forces(c)
        eps = 1e-3
        for i, d in [(0, 0), (5, 1), (13, 2)]:
            dp, dm = c.copy(), c.copy()
            dp[i, d] += eps
            dm[i, d] -= eps
            fd = -(energy(dp) - energy(dm)) / (2 * eps)
            assert abs(fd - f[i, d]) < 2e-2

    def test_gaq_lee_shrinks_with_the_codebook(self, setup):
        errs = {}
        R = torch.from_numpy(rotation(4))
        for bits in (6, 12):
            _, tc = cfgs("gaq_w4a8", {}, dir_bits=bits)
            cb = tcb.make_codebook(bits)
            errs[bits] = float(tlee.lee(
                lambda c: tso3.forces(setup["tp"], tc, setup["species"], c,
                                      cb), _t(setup["coords"][0]), R))
        assert errs[12] < errs[6] + 1e-9
