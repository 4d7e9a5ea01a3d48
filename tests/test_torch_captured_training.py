"""The training programs as one body for two uses, on the CPU.

The reference jits its training and evaluation programs: the SO3 QAT
trainer's ``step_warm`` / ``step_full``, ``evaluate``'s batch, the
pipeline's LEE force call and NVE trajectory, and the LM launcher's
step. The port writes each as one plain function over fixed-shape
buffers, which the card captures as a CUDA graph and replays
(``repro_torch.captured.Programs``) and the CPU calls eagerly, so these
tests run the code the card captures:

- no body reads a value back to the host (a dispatch mode raises on
  ``aten._local_scalar_dense``, ``nonzero``, ``unique*``,
  ``masked_select`` and ``equal``), each run through its real entry
  point (``train``, ``evaluate``, ``lee_eval``, ``nve_eval``, the
  launcher's ``main`` on the gloo (1, 1) mesh);
- ``train`` never writes ``init``, and its steps are the eager step
  sequence bit for bit;
- the LEE and NVE evaluations, which clone each output before the next
  call, give the eager functions' numbers bit for bit;
- two epochs with a warm-up epoch through ``train`` match the JAX
  package's ``train`` to ``test_torch_training``'s tolerances (float32:
  a quantized run moves A8 and MDDQ codes at rounding ties, which moves
  an update by a whole learning rate; ``test_torch_training`` pins those
  per step);
- ``clone_tree`` and ``copy_into`` on DTensors (a DTensor's own
  ``data_ptr()`` reads 0).
"""
import contextlib
import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro.data import synthetic_md as jsmd
from repro.models import so3krates as jso3
from repro.training import so3_trainer as jtr
from repro_torch import captured
from repro_torch.captured import Programs, clone_tree, copy_into
from repro_torch.core.codebook import make_codebook
from repro_torch.core.lee import lee, random_rotations
from repro_torch.core.mddq import MDDQConfig
from repro_torch.core.quantizers import log_magnitude_bounds
from repro_torch.data.synthetic_md import MASSES, make_ff
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.md.nve import MDState, init_state, kinetic_energy, _FS
from repro_torch.models import so3krates as tso3
from repro_torch.training import pipeline as tpipe
from repro_torch.training import so3_trainer as ttr
from repro_torch.weights import params_from_numpy
from test_torch_qat import CFG_KW, _np, cfgs
from test_torch_training import _jax_permutations

QAT = dict(epochs=2, warmup_epochs=1, batch_size=2, lr=1e-3, lee_weight=1.0,
           lee_rotations=2)
HOST_READS = ("local_scalar_dense", "nonzero", "unique", "masked_select",
              "equal")


@pytest.fixture(scope="module")
def setup():
    data = jax.jit(jsmd.sample_dataset, static_argnums=1)(
        jax.random.PRNGKey(0), 4)
    data = {k: np.asarray(v) for k, v in data.items()}
    jp = jax.jit(jso3.init_params, static_argnums=1)(
        jax.random.PRNGKey(1), jso3.So3kratesConfig(**CFG_KW))
    tp = params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, "cpu")
    return dict(data=data, jp=jp, tp=tp)


class NoHostReads(TorchDispatchMode):
    """Raises on an op that reads a tensor's value back to the host or
    sizes its output by the data (those of ``HOST_READS``, and indexing by
    a boolean mask, which runs ``nonzero``): on the card each is a host
    sync, which a capture forbids."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        masked = name in ("index", "index_put", "index_put_") and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in args[1])
        if name.lstrip("_").startswith(HOST_READS) or masked:
            raise AssertionError(f"a host read in a body: aten.{name}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def bodies_checked():
    """Inside the block every ``Programs.run`` on the CPU runs its body
    under :class:`NoHostReads`; yields the (program name, key) pairs run.
    The float32 log-magnitude bounds are taken first: ``log_magnitude_bounds``
    computes them from CPU constants once per process (on the card in a
    capture's eager warm-up)."""
    log_magnitude_bounds(MDDQConfig.m_min, MDDQConfig.m_max)
    run, seen = Programs.run, []

    def checked_run(self, key, fn, **inputs):
        seen.append((self.name, key))

        def checked(**kw):
            with NoHostReads():
                return fn(**kw)
        return run(self, key, checked, **inputs)
    Programs.run = checked_run
    try:
        yield seen
    finally:
        Programs.run = run


def test_no_host_read_in_the_so3_bodies(setup):
    """The warm-up step, the full step with its LEE term, the evaluate
    batch (a whole one and the tail), the LEE force call and the NVE
    segment (the record interval and the tail) each run under
    :class:`NoHostReads`."""
    d = setup["data"]
    _, tc = cfgs("gaq_w4a8", {})
    with bodies_checked() as seen:
        ttr.train(tc, d, ttr.TrainConfig(**QAT), init=setup["tp"],
                  device="cpu")
        ttr.evaluate(tc, setup["tp"], d, batch=3, device="cpu")
        tpipe.lee_eval(tc, setup["tp"], d, 1, 1, device="cpu")
        tpipe.nve_eval(tc, setup["tp"], d, 7, record_every=5, device="cpu")
    assert set(seen) == {
        ("the SO3 training step", "warm-up"), ("the SO3 training step",
                                               "full"),
        ("the SO3 evaluation batch", 3), ("the SO3 evaluation batch", 1),
        ("the LEE force call", 24), ("the NVE segment", 5),
        ("the NVE segment", 2)}


def test_no_host_read_in_the_launcher_step(tmp_path):
    """The launcher's qat_w4a8 + ef8 step on the gloo (1, 1) mesh, every
    one of a 12-step run (its loss falls, as the launcher checks), under
    :class:`NoHostReads`."""
    with bodies_checked() as seen:
        launcher.main(["--arch", "qwen2-0.5b", "--smoke", "--device", "cpu",
                       "--steps", "12", "--batch", "2", "--seq", "16",
                       "--lr", "3e-3", "--quant", "qat_w4a8",
                       "--grad-compression", "ef8", "--ckpt-dir",
                       str(tmp_path)])
    assert seen == [("the launcher's step", "step")] * 12
    assert not dist.is_initialized()


def _qat_train(setup, init):
    _, tc = cfgs("gaq_w4a8", {})
    return ttr.train(tc, setup["data"], ttr.TrainConfig(**QAT), init=init,
                     device="cpu")


@pytest.fixture(scope="module")
def qat_run(setup):
    """One gaq_w4a8 run (an epoch of warm-up, one full) from the JAX
    package's initial weights, and a copy of them taken before it."""
    before = {k: v.clone() for k, v in setup["tp"].items()}
    return before, _qat_train(setup, setup["tp"])


def test_train_leaves_init_untouched(setup, qat_run):
    """Two QAT runs from one ``init`` equal two runs from two copies of
    it, and ``init`` still holds its values; the result is no buffer of
    ``init``."""
    before, (first, h_first) = qat_run
    second, h_second = _qat_train(setup, setup["tp"])
    copies = [_qat_train(setup, {k: v.clone() for k, v in before.items()})
              for _ in range(2)]
    for k, v in setup["tp"].items():
        assert torch.equal(v, before[k]), k
        assert first[k].data_ptr() != v.data_ptr()
    for params, hist in [(second, h_second)] + copies:
        assert hist["loss"] == h_first["loss"]
        assert all(torch.equal(params[k], first[k]) for k in first)


def test_qat_train_is_the_eager_step_sequence(setup, qat_run):
    """``train``'s steps through the body equal the functional
    ``train_step`` (no buffer written in place) run step by step on the
    same frames and rotations, bit for bit."""
    before, (params, hist) = qat_run
    d, (_, tc) = setup["data"], cfgs("gaq_w4a8", {})
    tcfg = ttr.TrainConfig(**QAT)
    data = ttr.to_device(d, "cpu")
    cb = make_codebook(tc.dir_bits)
    opt = ttr.make_optimizer(tcfg, 4)
    fns = [ttr.make_loss_fn(dataclasses.replace(tc, freeze_vec_quant=warm),
                            data["species"], cb, tcfg)
           for warm in (True, False)]
    rng = np.random.default_rng(tcfg.seed)
    p, state, losses = dict(before), opt.init(before), []
    for epoch in range(2):
        perm = rng.permutation(4)
        for s in range(2):
            idx = torch.as_tensor(perm[2 * s:2 * s + 2])
            rots = random_rotations(rng, tcfg.lee_rotations)
            p, state, loss, _ = ttr.train_step(
                fns[epoch], opt, p, state, data["coords"][idx],
                data["energy"][idx], data["forces"][idx], rots)
            losses.append(float(loss))
    assert hist["loss"] == [(losses[0] + losses[1]) / 2,
                            (losses[2] + losses[3]) / 2]
    assert all(torch.equal(params[k], p[k]) for k in p)


def test_two_epochs_with_warmup_match_jax(setup):
    """fp32, one warm-up epoch and one full (both step programs, the
    state carried from one to the other), with the JAX trainer's
    permutations: parameters to 1e-4 and the epoch losses to 1e-5, as
    ``test_two_epoch_fp32_train_matches_jax`` holds them."""
    d = setup["data"]
    jc, tc = cfgs("none", {})
    tcfg = dict(epochs=2, warmup_epochs=1, batch_size=2, lr=5e-3)
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


def _eager_lee_eval(cfg, params, data, n_rot, n_cfg):
    """``pipeline.lee_eval`` as it was before its force call became a
    program: the force function called directly."""
    data = ttr.to_device(data, "cpu")
    cb = make_codebook(cfg.dir_bits) if cfg.quant != "none" else None
    rots = torch.from_numpy(random_rotations(123, n_rot))

    def force_fn(c):
        return tso3.forces(params, cfg, data["species"], c, cb)
    return float(np.mean([float(lee(force_fn, data["coords"][i], rots[r]))
                          for i in range(n_cfg) for r in range(n_rot)]))


def _eager_nve_energies(cfg, params, data, n_steps, record_every):
    """``pipeline.nve_eval``'s trajectory as it was before its segment
    became a program: velocity Verlet on fresh tensors each step."""
    data = ttr.to_device(data, "cpu")
    cb = make_codebook(cfg.dir_bits) if cfg.quant != "none" else None
    e_scale = float(data["e_scale"])
    masses = torch.tensor(MASSES, dtype=torch.float32)

    def force_fn(c):
        return tso3.forces(params, cfg, data["species"], c, cb) * e_scale

    def energy_fn(c):
        with torch.no_grad():
            return tso3.energy(params, cfg, data["species"], c, cb) \
                * e_scale
    s = init_state(7, make_ff("cpu")[0], masses, force_fn, 300.0)
    dt, inv_m = 0.5 * _FS, (1.0 / masses)[:, None]
    energies = []
    n_rec, tail = divmod(n_steps, record_every)
    for length in [record_every] * n_rec + ([tail] if tail else []):
        for _ in range(length):
            v_half = s.veloc + 0.5 * dt * s.forces * inv_m
            r_new = s.coords + dt * v_half
            f_new = force_fn(r_new)
            s = MDState(r_new, v_half + 0.5 * dt * f_new * inv_m, f_new)
        energies.append(energy_fn(s.coords) + kinetic_energy(s, masses))
    return torch.stack(energies).numpy().tolist()


@pytest.mark.parametrize("quant", ["none", "gaq_w4a8"])
def test_lee_and_nve_evals_are_the_eager_functions(setup, quant):
    """Through the programs' path (each force call's result cloned before
    the next, each NVE record cloned before the next segment) the LEE
    and the NVE energies are the eager functions' bit for bit; the
    integration leaves the equilibrium geometry it starts from as it
    was."""
    d = {**setup["data"], "coords": setup["data"]["coords"][:2]}
    _, tc = cfgs(quant, {})
    assert tpipe.lee_eval(tc, setup["tp"], d, 2, 2, device="cpu") \
        == _eager_lee_eval(tc, setup["tp"], d, 2, 2)
    eq = make_ff("cpu")[0].clone()
    nve = tpipe.nve_eval(tc, setup["tp"], d, 12, record_every=5,
                         device="cpu")
    assert nve["energies"] == _eager_nve_energies(tc, setup["tp"], d, 12, 5)
    assert torch.equal(make_ff("cpu")[0], eq)


def test_programs_carry_their_state_on_the_cpu():
    """On the CPU ``Programs.run`` calls the body eagerly on its state,
    which the body advances in place, and captures nothing."""
    progs = Programs(device="cpu", name="a counter",
                     state={"n": torch.zeros(())})

    def body(state, by):
        copy_into(state, {"n": state["n"] + by})
        return state["n"] * 2
    out = [float(progs.run("k", body, by=torch.tensor(float(i))))
           for i in range(1, 4)]
    assert out == [2.0, 6.0, 12.0] and float(progs.state["n"]) == 6.0
    assert progs.programs == {} and progs.pool is None
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        captured.CapturedProgram(body, {"state": progs.state, "by": 1.0},
                                 device="cpu", name="a counter")


def test_a_programs_graph_is_released_under_the_graphs_lock():
    """A captured program's graph is destroyed holding ``_GRAPHS_LOCK``,
    which a capture on another thread takes to register its graph: the
    CUDA generator's set of graphs is not thread-safe on the card's
    torch."""
    held = []

    def probe():
        got = captured._GRAPHS_LOCK.acquire(blocking=False)
        if got:
            captured._GRAPHS_LOCK.release()
        held.append(not got)

    class Graph:
        def __del__(self):
            t = threading.Thread(target=probe)
            t.start()
            t.join(10)

    prog = object.__new__(captured.CapturedProgram)
    prog.graph = Graph()
    del prog
    assert held == [True]


def test_clone_tree_and_copy_into_on_dtensors():
    """On the gloo (1, 1) mesh: ``clone_tree`` gives DTensors of the same
    placements and values in storage of their own; ``copy_into`` copies a
    DTensor leaf (whose own ``data_ptr()`` reads 0, so comparing those
    would skip every copy) and skips one that is its destination."""
    mesh = make_local_mesh("cpu")
    try:
        src = {"w": distribute_tensor(torch.arange(6.0).reshape(2, 3), mesh,
                                      [Replicate(), Replicate()]),
               "opt": (torch.ones(2), None)}
        dst = clone_tree(src)
        assert isinstance(dst["w"], DTensor)
        assert dst["w"].placements == src["w"].placements
        assert dst["w"].to_local().data_ptr() != \
            src["w"].to_local().data_ptr()
        assert torch.equal(dst["w"].full_tensor(), src["w"].full_tensor())
        assert dst["opt"][1] is None
        new = {"w": src["w"] * 3, "opt": (torch.full((2,), 5.0), None)}
        copy_into(dst, new)
        assert torch.equal(dst["w"].full_tensor(),
                           torch.arange(6.0).reshape(2, 3) * 3)
        assert torch.equal(dst["opt"][0], torch.full((2,), 5.0))
        copy_into(dst, dst)                     # a leaf that is its own
        assert torch.equal(src["w"].full_tensor(),
                           torch.arange(6.0).reshape(2, 3))
    finally:
        dist.destroy_process_group()


def test_the_launcher_step_body_is_make_step():
    """``make_body``'s step writes ``make_step``'s new parameters, AdamW
    state and residual into the state it read, bit for bit, and returns
    the same loss (float32 smoke config, plain tensors)."""
    from repro_torch import configs
    from repro_torch.data.tokens import synthetic_token_batches
    from repro_torch.models.lm.transformer import init_lm
    from repro_torch.optim.compression import ef_init
    from repro_torch.tools.lm_train_gap import launcher_optimizer
    cfg = dataclasses.replace(configs.get_smoke_config("qwen2-0.5b"),
                              quant_mode="qat_w4a8", dtype=torch.float32)
    opt = launcher_optimizer(10)
    params = init_lm(cfg, seed=0, device="cpu")
    it = synthetic_token_batches(cfg, 2, 16, seed=17)
    batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
    it.close()
    state = clone_tree((params, opt.init(params), ef_init(params)))
    *want, loss = launcher.make_step(cfg, opt, True)(
        params, opt.init(params), ef_init(params), batch)
    got = launcher.make_body(cfg, opt, True)(state, batch)
    assert torch.equal(got, loss)
    assert all(torch.equal(a, b) for a, b in zip(
        captured.tree_tensors(state), captured.tree_tensors(tuple(want))))

