"""Whole runs of the tiny cells on the CPU, past the harness's look for a
card: a sound run is correct, and a run with each fault planted under the
timed path is not.  On a card, the same for the control."""

import pytest

from benchmark import faults, harness

SEED = 2 ** 31 + 99


@pytest.mark.parametrize("cell", ["tiny.haploid", "tiny.hic"])
def test_sound_run_is_correct(tiny_root, cell):
    out = harness.run(cell, SEED, 0.1, False, "cpu",
                      spec=harness.Spec(tiny_root))
    assert out["correct"], out["checks"]
    assert out["attempted"] == 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell,variant", [
    ("tiny.haploid", faults.CONTROL),
    ("tiny.haploid", "ec_unchanged"),       # a step returns its state
    ("tiny.haploid", "ec_half"),            # half of the batch left out
    ("tiny.haploid", "ctg_half"),
    ("tiny.haploid", "ctg_altered"),        # an answer altered
])
def test_fault_is_caught(tiny_root, cell, variant):
    out = harness.run(cell, SEED, 0.1, False, "cpu", variant=variant,
                      spec=harness.Spec(tiny_root))
    assert not out["correct"], out["checks"]
    assert out["failed"] == 1


def test_window_that_runs_out_of_inputs_fails(tiny_root, monkeypatch):
    """A window longer than its inputs last ends, and is not correct:
    no input is assembled twice."""
    cell = harness.Spec.cell

    def one_input(self, name):
        c = cell(self, name)
        c.traffic["inputs"] = 1
        return c
    monkeypatch.setattr(harness.Spec, "cell", one_input)
    out = harness.run("tiny.haploid", SEED, 1e9, False, "cpu",
                      spec=harness.Spec(tiny_root))
    assert not out["correct"]
    assert out["attempted"] == 2 and out["failed"] == 1


@pytest.mark.cuda
def test_control_fails_on_the_card(tiny_root, card):
    spec = harness.Spec(tiny_root)
    assert harness.run("tiny.haploid", SEED, 0.1, False, card,
                       spec=spec)["correct"]
    assert not harness.run("tiny.haploid", SEED, 0.1, False, card,
                           variant=faults.CONTROL, spec=spec)["correct"]
