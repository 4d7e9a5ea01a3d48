"""The port's training slice against the JAX package, on the CPU.

Modules: ``data/synthetic_md`` (the topology exactly, the classical force
field to 1e-5, MD-sampled frames from one handed-in initial state to
1e-4), ``optim/adamw`` (one update and the schedule to 1e-6),
``training/so3_trainer`` (``make_loss_fn``'s loss to 1e-5 relative and
every parameter gradient to 1e-4 of the leaf's largest |g|, second order
through the force loss and the LEE term under JAX's rotations, in all
five ``quant`` modes and with ``freeze_vec_quant``; a 2-epoch fp32
``train`` with JAX's permutations, params to 1e-4; ``evaluate``) and
``training/pipeline`` (``.npz`` parameter files both ways, bit for bit;
the LEE, NVE and latency evaluations). JAX references are jitted, as the
JAX trainer runs them, and computed once per module fixture.

A quantized case that misses its tolerance must come with a moved site
(``test_torch_qat.moved_sites``: an A8 code or clip gate, or an MDDQ
code, that differs between the packages in the batch's forward or in
one of the LEE term's forwards); the test prints them and fails without
one. Then the port runs again with the JAX package's values pinned at
every site (recorded from inside the jitted reference), and that run
must hold the tolerances.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import make_codebook as j_make_codebook
from repro.core import random_rotations as j_random_rotations
from repro.data import synthetic_md as jsmd
from repro.md.nve import init_state as j_init_state
from repro.models import so3krates as jso3
from repro.optim.adamw import AdamW as JAdamW
from repro.optim.adamw import cosine_schedule as j_cosine_schedule
from repro.training import pipeline as jpipe
from repro.training import so3_trainer as jtr
from repro_torch.core.codebook import make_codebook
from repro_torch.data import synthetic_md as tsmd
from repro_torch.models import so3krates as tso3
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.training import pipeline as tpipe
from repro_torch.training import so3_trainer as ttr
from repro_torch.weights import params_from_numpy
from test_torch_qat import (CFG_KW, MODE_IDS, MODES, _np, _t, assemble,
                            cfgs, jax_recorded_sites, moved_sites,
                            port_sites)

TCFG = dict(lee_weight=1.0, lee_rotations=2)
LOSS_REL, GRAD_REL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def setup():
    data = jax.jit(jsmd.sample_dataset, static_argnums=1)(
        jax.random.PRNGKey(0), 4)
    data = {k: np.asarray(v) for k, v in data.items()}
    jp = jax.jit(jso3.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jso3.So3kratesConfig(**CFG_KW))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    key = jax.random.PRNGKey(5)
    rots = np.asarray(j_random_rotations(key, TCFG["lee_rotations"]))
    tcfg = jtr.TrainConfig(**TCFG)
    c0 = data["coords"][0]
    rotated = [c0 @ R.T for R in rots]
    loss_refs = {}
    for mode_id, (quant, extra) in zip(MODE_IDS, MODES):
        jc, _ = cfgs(quant, extra)
        cb = j_make_codebook(jc.dir_bits) if quant != "none" else None
        loss_fn = jtr.make_loss_fn(jc, jnp.asarray(data["species"]), cb,
                                   tcfg)
        # jitted, as the JAX trainer's step, with its quantization sites
        # recorded from inside: the batch's forward, then the LEE term's
        # rotated and given first molecule, in the port's call order
        with jax_recorded_sites() as calls:
            (loss, _), grads = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(jp, data["coords"], data["energy"],
                                        data["forces"], key)
            grads = {k: np.asarray(g) for k, g in grads.items()}
        sites = assemble(calls, 0, data["coords"])
        if quant != "none":
            lee = [assemble(calls, 1, rotated), assemble(calls, 2, [c0, c0])]
            for r in range(len(rots)):
                for part in lee:
                    sites += [(k, a if k[0] == "w" else a[r])
                              for k, a in part]
        loss_refs[mode_id] = (float(loss), grads, sites)
    return dict(data=data, jp=jp, tp=tp, rots=rots, loss_refs=loss_refs)


def _batch(data):
    return [_t(data[k]) for k in ("coords", "energy", "forces")]


# --- 6. data ------------------------------------------------------------------

class TestData:
    def test_topology_is_the_jax_packages(self):
        for a, b in zip(tsmd.azobenzene_topology(),
                        jsmd.azobenzene_topology()):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        eq, sp, _ = tsmd.make_ff("cpu")
        jeq, jsp, _ = jsmd.make_ff()
        np.testing.assert_array_equal(_np(eq), np.asarray(jeq))
        np.testing.assert_array_equal(_np(sp), np.asarray(jsp))

    def test_classical_ff_energy_and_forces(self, setup):
        _, _, jff = jsmd.make_ff()
        _, _, tff = tsmd.make_ff("cpu")
        c = setup["data"]["coords"]
        je, jf = (np.asarray(a) for a in jax.jit(lambda x: (
            jax.vmap(jff.energy)(x), jax.vmap(jff.forces)(x)))(c))
        te, tf = tff.energy(_t(c)), tff.forces(_t(c))
        np.testing.assert_allclose(_np(te), je, rtol=1e-5)
        np.testing.assert_allclose(_np(tf), jf, atol=1e-5 * np.abs(jf).max())
        np.testing.assert_allclose(_np(tff.energy(_t(c[1]))), je[1],
                                   rtol=1e-5)

    def test_md_frames_from_one_initial_state(self):
        key = jax.random.PRNGKey(3)
        eq, _, jff = jsmd.make_ff()
        masses = jnp.array([12.011] * 12 + [14.007] * 2 + [1.008] * 10)
        veloc = np.asarray(j_init_state(key, eq, masses, jff.forces,
                                        300.0).veloc)
        j = jax.jit(lambda k: jsmd.sample_dataset_md(k, 4, stride=10))(key)
        t = tsmd.sample_dataset_md(0, 4, stride=10, device="cpu",
                                   veloc=veloc)
        for k in ("coords", "energy", "forces"):
            ref = np.asarray(j[k])
            np.testing.assert_allclose(_np(t[k]), ref,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=k)
        assert float(t["e_scale"]) == pytest.approx(float(j["e_scale"]),
                                                    rel=1e-4)

    def test_sample_dataset_labels_and_standardization(self):
        d = tsmd.sample_dataset(0, 16, device="cpu")
        _, _, ff = tsmd.make_ff("cpu")
        assert d["coords"].shape == (16, 24, 3)
        np.testing.assert_allclose(
            _np(d["energy"] * d["e_scale"] + d["e_shift"]),
            _np(ff.energy(d["coords"])), rtol=1e-5, atol=1e-4)
        assert float(d["energy"].std(correction=0)) == pytest.approx(1.0,
                                                                     1e-4)
        a = tsmd.sample_dataset(np.random.default_rng(0), 16, device="cpu")
        np.testing.assert_array_equal(_np(a["coords"]), _np(d["coords"]))


# --- 7. the optimizer ---------------------------------------------------------

@pytest.mark.parametrize("wd", [0.0, 0.01])
def test_adamw_update_and_schedule(wd):
    rng = np.random.default_rng(6)
    p = {k: rng.normal(size=(5, 4)).astype(np.float32) for k in "abc"}
    g = {k: (30 * rng.normal(size=(5, 4))).astype(np.float32) for k in "abc"}
    jopt = JAdamW(lr=j_cosine_schedule(1e-2, 3, 20), grad_clip=10.0,
                  weight_decay=wd)
    topt = AdamW(lr=cosine_schedule(1e-2, 3, 20), grad_clip=10.0,
                 weight_decay=wd)
    jpar = {k: jnp.asarray(v) for k, v in p.items()}
    tpar = {k: _t(v) for k, v in p.items()}
    js, ts = jopt.init(jpar), topt.init(tpar)
    for _ in range(4):
        jpar, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                               js, jpar)
        tpar, ts = topt.update({k: _t(v) for k, v in g.items()}, ts, tpar)
    for k in p:
        np.testing.assert_allclose(_np(tpar[k]), np.asarray(jpar[k]),
                                   atol=1e-6)
        np.testing.assert_allclose(_np(ts.nu[k]), np.asarray(js.nu[k]),
                                   rtol=1e-6)
    assert float(ts.step) == int(js.step) == 4
    for s in range(25):
        np.testing.assert_allclose(
            float(cosine_schedule(1e-2, 3, 20)(torch.tensor(s))),
            float(j_cosine_schedule(1e-2, 3, 20)(jnp.int32(s))), atol=1e-6)


# --- 8. the trainer ---------------------------------------------------------

@pytest.mark.parametrize("mode_id", MODE_IDS)
def test_loss_and_second_order_gradients_match_jax(setup, mode_id):
    quant, extra = dict(zip(MODE_IDS, MODES))[mode_id]
    jc, tc = cfgs(quant, extra)
    d = setup["data"]
    cb = make_codebook(tc.dir_bits) if quant != "none" else None
    loss_fn = ttr.make_loss_fn(tc, _t(d["species"]), cb,
                               ttr.TrainConfig(**TCFG))
    assert loss_fn.use_lee == (quant != "none")
    with port_sites() as p_sites:
        loss, (l_e, l_f), grads = ttr.loss_and_grads(
            loss_fn, setup["tp"], *_batch(d), setup["rots"])
    j_loss, j_grads, j_sites = setup["loss_refs"][mode_id]
    assert set(grads) == set(j_grads)
    rel_loss = abs(float(loss) - j_loss) / abs(j_loss)
    rel_g = {k: float(np.abs(_np(grads[k]) - g).max()
                      / max(np.abs(g).max(), 1e-30))
             for k, g in j_grads.items()}
    worst = max(rel_g, key=rel_g.get)
    if rel_loss <= LOSS_REL and rel_g[worst] <= GRAD_REL:
        return
    moved = moved_sites(j_sites, p_sites)
    print(f"{mode_id}: loss {rel_loss:.3g}, worst gradient {worst} "
          f"{rel_g[worst]:.3g}; moved codes or gates per site {moved}")
    assert quant != "none" and sum(moved) > 0, (rel_loss, worst, moved)
    # the JAX package's codes and gates pinned: within the tolerances
    with port_sites(pin=j_sites):
        loss, _, grads = ttr.loss_and_grads(loss_fn, setup["tp"],
                                            *_batch(d), setup["rots"])
    assert abs(float(loss) - j_loss) <= LOSS_REL * abs(j_loss)
    for k, g in j_grads.items():
        assert float(np.abs(_np(grads[k]) - g).max()) \
            <= GRAD_REL * max(np.abs(g).max(), 1e-30), k


def test_svq_leaves_get_zero_gradient(setup):
    """SVQ detaches the vector branch: its weights get zeros, as JAX's."""
    j_grads = setup["loss_refs"]["svq_kmeans"][1]
    assert not np.abs(j_grads["layer0/wb"]).any()
    _, tc = cfgs("svq_kmeans", {"robust_attention": False})
    d = setup["data"]
    loss_fn = ttr.make_loss_fn(tc, _t(d["species"]), make_codebook(8),
                               ttr.TrainConfig(**TCFG))
    _, _, grads = ttr.loss_and_grads(loss_fn, setup["tp"], *_batch(d),
                                     setup["rots"])
    assert not grads["layer0/wb"].any()


def _jax_permutations(seed, epochs, n, steps):
    """The epoch permutations of the JAX trainer's key sequence."""
    key = jax.random.PRNGKey(seed)
    key, _ = jax.random.split(key)
    perms = []
    for _ in range(epochs):
        key, ekey = jax.random.split(key)
        perms.append(np.asarray(jax.random.permutation(ekey, n)))
        for _ in range(steps):
            key, _ = jax.random.split(key)
    return perms


def test_two_epoch_fp32_train_matches_jax(setup):
    d = setup["data"]
    jc, tc = cfgs("none", {})
    tcfg = dict(epochs=2, warmup_epochs=0, batch_size=2, lr=5e-3)
    j_params, j_hist = jtr.train(jc, {k: jnp.asarray(v) for k, v in
                                      d.items()},
                                 jtr.TrainConfig(**tcfg), init=setup["jp"])
    t_params, t_hist = ttr.train(tc, d, ttr.TrainConfig(**tcfg),
                                 init=setup["tp"], device="cpu",
                                 perms=_jax_permutations(0, 2, 4, 2))
    for k, v in j_params.items():
        v = np.asarray(v)
        np.testing.assert_allclose(_np(t_params[k]), v,
                                   atol=1e-4 * max(np.abs(v).max(), 1.0),
                                   err_msg=k)
    np.testing.assert_allclose(t_hist["loss"], j_hist["loss"], rtol=1e-5)
    assert len(t_hist["step_ms"]) == 4


def test_qat_train_with_warmup_runs_both_step_kinds(setup):
    """gaq_w4a8 with one warm-up epoch: finite losses, the LEE rotations
    drawn per step from the seed (or taken as given), the same result
    from the same seed."""
    d = setup["data"]
    _, tc = cfgs("gaq_w4a8", {})
    tcfg = ttr.TrainConfig(epochs=2, warmup_epochs=1, batch_size=4, lr=1e-3,
                           **TCFG)
    a, ha = ttr.train(tc, d, tcfg, init=setup["tp"], device="cpu")
    b, hb = ttr.train(tc, d, tcfg, init=setup["tp"], device="cpu")
    assert np.isfinite(ha["loss"]).all() and ha["loss"] == hb["loss"]
    rots = [np.eye(3, dtype=np.float32)[None].repeat(2, 0)] * 2
    _, hc = ttr.train(tc, d, tcfg, init=setup["tp"], device="cpu",
                      rotations=rots)
    assert hc["loss"] != ha["loss"]


def test_evaluate_matches_jax(setup):
    d = setup["data"]
    jc, tc = cfgs("gaq_w4a8", {})
    j = jtr.evaluate(jc, setup["jp"], {k: jnp.asarray(v) for k, v in
                                       d.items()}, batch=3)
    t = ttr.evaluate(tc, setup["tp"], d, batch=3, device="cpu")
    assert t["e_mae"] == pytest.approx(j["e_mae"], rel=1e-4)
    assert t["f_mae"] == pytest.approx(j["f_mae"], rel=1e-4)


# --- 9. the pipeline ----------------------------------------------------------

def test_npz_params_both_ways(setup, tmp_path):
    jpipe.save_params(str(tmp_path / "j.npz"), setup["jp"])
    t = tpipe.load_params(str(tmp_path / "j.npz"), "cpu")
    tpipe.save_params(str(tmp_path / "t.npz"), t)
    j = jpipe.load_params(str(tmp_path / "t.npz"))
    assert set(t) == set(j) == set(setup["jp"])
    for k, v in setup["jp"].items():
        np.testing.assert_array_equal(_np(t[k]), np.asarray(v))
        np.testing.assert_array_equal(np.asarray(j[k]), np.asarray(v))


def test_lee_nve_and_latency_evals(setup):
    d = {**setup["data"], "coords": setup["data"]["coords"][:2]}
    _, t32 = cfgs("none", {})
    _, tq = cfgs("gaq_w4a8", {})
    assert tpipe.lee_eval(t32, setup["tp"], d, 2, 2, device="cpu") < 1e-4
    assert tpipe.lee_eval(tq, setup["tp"], d, 2, 2, device="cpu") > 1e-4
    nve = tpipe.nve_eval(tq, setup["tp"], d, 20, record_every=5,
                         device="cpu")
    assert len(nve["energies"]) == 4 and not nve["blew_up"]
    assert np.isfinite(nve["drift_ev_per_atom_ps"])
    lat = tpipe.latency_eval(t32, setup["tp"], dim=64, n_mats=2,
                             device="cpu")
    assert lat["device"] == "cpu" and lat["bytes_int4"] == 2 * 64 * 32
    assert lat["model_bytes_fp32"] == 4 * sum(v.numel() for v in
                                              setup["tp"].values())


def test_train_config_defaults_are_the_jax_packages():
    assert dataclasses.asdict(ttr.TrainConfig()) \
        == dataclasses.asdict(jtr.TrainConfig())
