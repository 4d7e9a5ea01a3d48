"""The classical-MD sampler as one frame body for two uses, on the CPU.

The reference samples the training set's frames with two nested
``lax.scan``s (a frame of ``stride`` velocity-Verlet steps, scanned over
the frames). The port writes one frame as a body over the carried
(r, v, f), which the card captures once per (atom count, stride, dt)
and replays once per frame, and which the CPU calls eagerly
(``data.synthetic_md.FrameSampler``). Here, on the CPU:

- the frames, and so the labelled dataset, are bit for bit those of the
  Python loop the sampler replaced (copied below), for several seeds and
  strides and for given initial velocities;
- the body reads no value back to the host (``NoHostReads``, the check
  of the training programs) and leaves no autograd graph on what it
  writes, under ``enable_grad`` too;
- one sampler per device, kept across calls, and the CPU captures
  nothing.
"""
import numpy as np
import pytest
import torch

from repro_torch.captured import tree_tensors
from repro_torch.data import synthetic_md as smd
from repro_torch.md.nve import _FS, init_state
from test_torch_captured_training import bodies_checked


def _loop_frames(seed, n_samples, temperature_K=300.0, dt_fs=0.5,
                 stride=40, veloc=None):
    """The sampler's frames as the port computed them before the frame
    program: one Python loop over every step."""
    eq, _, ff = smd.make_ff("cpu")
    masses = torch.tensor(smd.MASSES, dtype=torch.float32)
    r, v, f = init_state(seed, eq, masses, ff.forces, temperature_K,
                         veloc=veloc)
    dt = dt_fs * _FS
    inv_m = (1.0 / masses)[:, None]
    coords, velocs = [], []
    for _ in range(n_samples):
        for _ in range(stride):
            v_half = v + 0.5 * dt * f * inv_m
            r = r + dt * v_half
            f = ff.forces(r)
            v = v_half + 0.5 * dt * f * inv_m
        coords.append(r)
        velocs.append(v)
    return torch.stack(coords), torch.stack(velocs)


@pytest.mark.parametrize("seed,n_samples,stride,dt_fs",
                         [(0, 4, 40, 0.5), (3, 5, 7, 0.5), (11, 3, 1, 0.25)])
def test_frames_are_the_loop_bit_for_bit(seed, n_samples, stride, dt_fs):
    c_ref, v_ref = _loop_frames(seed, n_samples, dt_fs=dt_fs, stride=stride)
    coords, veloc = smd.sample_frames_md(seed, n_samples, dt_fs=dt_fs,
                                         stride=stride, device="cpu")
    assert torch.equal(coords, c_ref) and torch.equal(veloc, v_ref)
    data = smd.sample_dataset_md(seed, n_samples, dt_fs=dt_fs,
                                 stride=stride, device="cpu")
    eq, species, ff = smd.make_ff("cpu")
    ref = smd._labelled(c_ref, species, ff, True)
    assert set(data) == set(ref)
    for k in ref:
        assert torch.equal(data[k], ref[k]), k


def test_given_velocities_and_a_second_run_are_the_loop():
    """Initial velocities given as numpy (the JAX package's state), and a
    run after another: the carried state is reset by each call."""
    veloc = np.random.default_rng(5).standard_normal((24, 3)).astype(
        np.float32) * 0.01
    c_ref, _ = _loop_frames(0, 3, stride=6, veloc=veloc)
    smd.sample_frames_md(1, 2, stride=6, device="cpu")
    coords, _ = smd.sample_frames_md(0, 3, stride=6, device="cpu",
                                     veloc=veloc)
    assert torch.equal(coords, c_ref)


def test_no_host_read_in_the_frame_body():
    with bodies_checked() as seen:
        smd.sample_dataset_md(0, 3, stride=5, device="cpu")
    assert set(seen) == {("the classical-MD frame", (24, 5, 0.5))}


def test_the_frame_leaves_no_autograd_graph():
    """Run under ``enable_grad`` (as a caller inside a training step
    would), the body's forces come from ``autograd.grad`` and nothing it
    writes or returns carries a graph."""
    with torch.enable_grad():
        coords, veloc = smd.sample_frames_md(0, 2, stride=3, device="cpu")
        sampler = smd.frame_sampler("cpu")
        for t in [coords, veloc] + tree_tensors(sampler.programs.state):
            assert not t.requires_grad and t.grad_fn is None


def test_one_sampler_per_device_and_no_capture_on_the_cpu():
    a = smd.frame_sampler("cpu")
    smd.sample_dataset_md(0, 2, stride=2, device="cpu")
    assert smd.frame_sampler(torch.device("cpu")) is a
    assert a.programs.programs == {} and a.programs.pool is None
    eq, _, _ = smd.make_ff("cpu")
    assert torch.equal(a.eq, eq)
