"""A run with the timed path broken underneath comes out not correct:
the rest of each cell's run (its set-up, window and comparison) at a
small size on the CPU, with one fault planted in the program for each
fault the cell can have."""
import dataclasses

import pytest
import torch

from perfbench.common import checks_from, load_module
from perfbench.tests.tiny_cells import tiny

CPU = torch.device("cpu")
SEED = 2 ** 31 + 23


def _correct(name) -> bool:
    cell = tiny(name)
    out = load_module("drivers", cell.traffic["driver"]).run(
        cell, SEED, 0.3, False, CPU)
    return all(c.ok for c in checks_from(out.readings, cell.limits))


# --- MD: the segment is the timed path --------------------------------------------

def _md_state_unchanged(orig):
    def segment(self, state, species, mask, masses, length):
        _, rec = orig(self, state, species, mask, masses, length)
        return state, rec
    return segment


def _md_half_left_out(orig):
    def segment(self, state, species, mask, masses, length):
        new, rec = orig(self, state, species, mask, masses, length)
        half = state.coords.shape[0] // 2
        coords, veloc = new.coords.clone(), new.veloc.clone()
        coords[:half] = state.coords[:half]
        veloc[:half] = state.veloc[:half]
        return new._replace(coords=coords, veloc=veloc), rec
    return segment


def _md_answer_altered(orig):
    def energy_forces(self, species, coords, mask, nlist):
        e, f = orig(self, species, coords, mask, nlist)
        f = f.clone()
        f[0, 0] += f.pow(2).mean().sqrt()
        return e + 1.0, f
    return energy_forces


@pytest.mark.parametrize("name", ["md-w4a8-r128", "md-fp32-r128"])
@pytest.mark.parametrize("attr,fault", [
    ("_segment", _md_state_unchanged),
    ("_segment", _md_half_left_out),
    ("_energy_forces", _md_answer_altered)])
def test_md_faults(monkeypatch, name, attr, fault):
    from repro_torch.md.engine import MDEngine
    monkeypatch.setattr(MDEngine, attr, fault(getattr(MDEngine, attr)))
    assert not _correct(name)


# --- QAT: the step body is the timed path ------------------------------------------

def _qat_body(kind):
    import repro_torch.training.so3_trainer as tr
    orig = tr.step_body

    def body(loss_fn, opt, data, state, idx, rotations):
        if kind == "state_unchanged":
            snapshot = tr.clone_tree(state)
            out = orig(loss_fn, opt, data, state, idx, rotations)
            tr.copy_into(state, snapshot)
            return out
        if kind == "half_left_out":
            half = idx.shape[0] // 2
            idx = torch.cat([idx[:half], idx[:half]])
        loss, l_e, l_f = orig(loss_fn, opt, data, state, idx, rotations)
        if kind == "answer_altered":
            loss = loss * 1.5
        return loss, l_e, l_f
    return body


@pytest.mark.parametrize("kind", ["state_unchanged", "half_left_out",
                                  "answer_altered"])
def test_qat_faults(monkeypatch, kind):
    import repro_torch.training.so3_trainer as tr
    monkeypatch.setattr(tr, "step_body", _qat_body(kind))
    assert not _correct("qat-w4a8-b32")


# --- serving: infer_batch is the timed path -----------------------------------------

def _serve_fault(kind):
    from repro_torch.serving.engine import QuantizedEngine
    orig = QuantizedEngine.infer_batch
    calls = {"n": 0, "planted": 0}

    def infer(self, graphs, *args, **kw):
        calls["n"] += 1
        out = orig(self, graphs, *args, **kw)
        if getattr(self, "_warming", False):
            return out
        if kind == "answer_altered":
            out[0] = dataclasses.replace(out[0], energy=out[0].energy + 1.0)
        elif kind == "half_left_out" and len(out) > 1:
            half = len(out) // 2
            out[half:] = [dataclasses.replace(
                r, energy=out[0].energy) for r in out[half:]]
            calls["planted"] += 1
        elif kind == "lost" and calls["n"] % 3 == 0:
            raise RuntimeError("planted: a flush that never answers")
        return out
    infer.calls = calls
    return infer


@pytest.mark.parametrize("kind", ["answer_altered", "half_left_out",
                                  "lost"])
def test_serve_faults(monkeypatch, kind):
    from repro_torch.serving.engine import QuantizedEngine
    infer = _serve_fault(kind)
    monkeypatch.setattr(QuantizedEngine, "infer_batch", infer)
    assert not _correct("serve-w4a8-poisson")
    if kind == "half_left_out":
        assert infer.calls["planted"] > 0
